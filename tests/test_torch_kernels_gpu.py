"""The four CUDA kernels of pypmc_tpu_torch against their plain versions on
the card, at small sizes.  Marked ``gpu``: without a CUDA device every test
skips.  This file imports no JAX, so on a machine with a card and no JAX it
runs without the suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

The checks are those of ``chip_smoke.py`` (phase 3), at N of a few 10^5.
"""

import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("case", [
    # K, Kt, D, N, Student-t proposal, Student-t target, dead component, seed
    (10, 2, 10, 1 << 18, True, False, False, 1),
    (10, 2, 10, 200_003, False, True, True, 2),
    (1, 1, 1, 200_003, True, False, False, 3),
    (4, 2, 7, 200_003, True, True, True, 5),
    (2, 3, 32, 100_001, True, False, False, 8),
])
def test_kernels_against_plain_versions(cuda, case):
    chip_smoke.kernel_case(case, cuda, [])


def test_slice_step_against_unfused_update(cuda):
    chip_smoke.slice_reference(cuda, [])


def test_dispatch_and_launch_counts(cuda):
    from pypmc_tpu_torch.density import core
    from pypmc_tpu_torch.ops import kernels

    params, target, _ = chip_smoke.flagship_problem(cuda)
    ops = core._kernel_operands(params)
    kernels.reset_launch_counts()
    xT = core.propose_logq_T(params, 0, 1000, target)[0]
    core.mixture_logpdf_T(params, xT)
    assert kernels.launch_counts() == {"fused_logq": 1, "fused_propose_logq": 1,
                                       "fused_pmc_stats": 0, "fused_is_pmc_step": 0}
    with pytest.raises(TypeError):
        kernels.fused_logq(xT.double(), kernels.MixtureOperands(
            ops.packed.double(), ops.K, ops.dim, ops.student_t))
    with pytest.raises(ValueError, match="limit"):
        kernels.fused_logq(torch.zeros((33, 10), device=cuda), core._kernel_operands(
            core.make_mixture(torch.zeros((1, 33), device=cuda),
                              torch.eye(33, device=cuda)[None])[0]))
