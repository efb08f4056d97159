"""The CUDA kernels of pypmc_tpu_torch against their plain versions on
the card, at small sizes.  Marked ``gpu``: without a CUDA device every test
skips.  This file imports no JAX, so on a machine with a card and no JAX it
runs without the suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

The checks are those of ``chip_smoke.py`` (phases 3, 5, 6 and blocked), at
N of a few 10^5.
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
    (2, 2, 40, 100_001, False, True, False, 7),
    (1, 1, 128, 50_001, False, False, False, 9),
    # the statistics kernels' 64-particle tile
    (120, 2, 1, 200_003, True, False, False, 10),
    (120, 2, 1, 200_003, False, True, True, 11),
    # fused_is_pmc_step's register pass at the edges of its plan (one and
    # two groups at D=10, three row bands, eight groups at D=1), each also
    # through its entry-table pass; K=137, D=1 on the entry table
    (16, 2, 10, 200_003, True, False, True, 26),
    (17, 2, 10, 200_003, False, True, False, 27),
    (11, 2, 11, 100_001, True, True, True, 28),
    (8, 2, 16, 100_001, True, False, False, 29),
    (128, 2, 1, 200_003, True, False, True, 30),
    (137, 2, 1, 50_001, False, False, False, 31),
])
def test_kernels_against_plain_versions(cuda, case):
    chip_smoke.kernel_case(case, cuda, [])


@pytest.mark.parametrize("case", [
    # K, D, N, Student-t, dead component, zero weights, seed
    (10, 10, 1 << 18, True, False, False, 11),
    (10, 10, 200_003, False, True, True, 12),
    (1, 1, 200_003, True, False, True, 13),
    (4, 7, 200_003, True, True, False, 14),
    (3, 32, 100_001, False, False, True, 15),
    (2, 40, 100_001, True, False, True, 16),
    (60, 32, 50_001, False, True, False, 17),
    (1, 128, 50_001, False, False, True, 18),
    (32, 40, 50_001, True, False, False, 20),
    (200, 10, 50_001, True, False, False, 21),
    (5, 64, 50_001, False, True, True, 22),
    (3, 33, 100_001, True, False, False, 23),
    (120, 1, 200_003, True, False, True, 24),
    # fused_vb_estep's register pass at the edges of its plan, each also
    # through its entry-table pass; K=137, D=1 on the entry table
    (16, 10, 200_003, False, False, True, 32),
    (17, 10, 200_003, False, True, False, 33),
    (11, 11, 100_001, True, False, True, 34),
    (8, 16, 100_001, False, True, True, 35),
    (128, 1, 200_003, True, False, True, 36),
    (137, 1, 50_001, False, False, True, 37),
])
def test_maha_rho_vb_estep_against_plain_versions(cuda, case):
    chip_smoke.eval_case(case, cuda, [])


@pytest.mark.parametrize("case", [(K, D, 20_011, seed) for K, D, _, seed in chip_smoke.MAHA_CASES])
def test_maha_kernels_at_the_rules_largest_k(cuda, case):
    """fused_maha's record, tensor-core and tiled kernels at the JAX rule's
    largest K at D=17, 20 and 64, lower and upper operands, a dead
    component, ragged N: each within TOL["maha"] of float64, equal on a
    second run."""
    chip_smoke.maha_case(case, cuda, [])


@pytest.mark.parametrize("case", [(K, D, 4099 if D > 200 else 20_011, seed)
                                  for K, D, _, seed in chip_smoke.TILED_CASES]
                         + chip_smoke.MAHA_WIDE_CASES)
def test_maha_tensor_core_kernel_past_d64(cuda, case):
    """fused_maha's tensor-core kernel past D = 64 at K = 1 and the JAX
    rule's largest K to D = 2040, lower, upper and full operands, ragged N
    (and N a multiple of 4, its 16-byte x copies): elected and counted,
    within TOL["maha"] of float64 and of the forced tiled kernel, each
    kernel equal on a second run."""
    chip_smoke.maha_wide_case(case, cuda, [])


def test_maha_non_finite_particles(cuda):
    """The tensor-core kernels' NaNs and infinities are the FP32
    arithmetic's (the record kernel's to D = 64; each term formed on its
    own at every D)."""
    chip_smoke.maha_nonfinite_case(cuda, [])


def test_logq_and_rho_non_finite_particles(cuda):
    """fused_logq's and fused_rho's kernels (the record kernels to D = 64,
    the tensor-core ones past it, the tiled ones forced at every D) give
    exactly the plain version's NaN, +inf and -inf on particles with an
    infinite, a NaN and a 1e20 coordinate; their finite outputs within TOL
    of float64."""
    chip_smoke.evaluation_nonfinite_case(cuda, [])


def test_vb_estep_non_finite_particles(cuda):
    chip_smoke.vb_nonfinite_case(cuda, [])


@pytest.mark.parametrize("case", chip_smoke.PMC_STATS_CASES)
def test_pmc_stats_passes_against_plain_version(cuda, case):
    """fused_pmc_stats' register pass and entry table against the float64
    plain version: a second run equal, a dead component's statistics 0."""
    chip_smoke.pmc_stats_weighted_case(case, cuda, [])


def test_pmc_stats_non_finite_particles(cuda):
    chip_smoke.pmc_stats_nonfinite_case(cuda, [])


@pytest.mark.parametrize("case", [c for c in chip_smoke.GRAM_CASES if c[3] <= 1025]
                         + [c for c in chip_smoke.GRAM_CASES
                            if c[3] == chip_smoke.N_FLAGSHIP and c[:3] in ((7, 2, 17), (1, 1, 128))])
def test_gram_pass_against_plain_version(cuda, case):
    """fused_pmc_stats', fused_is_pmc_step's and fused_vb_estep's Gram pass
    (D = 17-128, K D <= 128) elected and counted, against the float64 plain
    version (fused_vb_estep to 2^20 particles, a third of the weights 0);
    the step's x and latent the entry table's bit for bit, its w the
    K-blocked step's to D = 64; a second run equal."""
    chip_smoke.gram_case(case, cuda, [])


@pytest.mark.parametrize("kernel", ["fused_is_pmc_step", "fused_vb_estep", "fused_pmc_stats"])
def test_register_pass_is_deterministic_and_elected(cuda, kernel):
    """At K=10, D=10 the register pass is elected and counted as such; one
    seed (one input) gives the same statistics twice; the step draws the
    same particles and weights on both passes."""
    from pypmc_tpu_torch.density import core
    from pypmc_tpu_torch.ops import kernels

    params, target, _ = chip_smoke.flagship_problem(cuda)
    ops, tops = core._kernel_operands(params), core._kernel_operands(target)
    n = 300_007
    kernels.reset_launch_counts()
    if kernel == "fused_is_pmc_step":
        runs = [kernels.fused_is_pmc_step((5, 6), ops, tops, n, True) for _ in range(2)]
        table = kernels.fused_is_pmc_step((5, 6), ops, tops, n, True, variant="table")
        for a, b in zip(runs[0][:3], table[:3]):
            assert torch.equal(a, b)
        outs = [list(r[:3]) + [r[3][key] for key in sorted(r[3])] for r in runs]
    elif kernel == "fused_pmc_stats":
        xT = kernels.fused_propose_logq((5, 6), ops, n)[0]
        w = torch.rand((n,), device=cuda)
        runs = [kernels.fused_pmc_stats(xT, w, ops, True) for _ in range(2)]
        outs = [[r[key] for key in sorted(r)] for r in runs]
    else:
        xT = kernels.fused_propose_logq((5, 6), ops, n)[0]
        w = torch.rand((n,), device=cuda)
        A, m, const = chip_smoke.vb_operands(params)
        outs = [kernels.fused_vb_estep(xT, w, A, m, const) for _ in range(2)]
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    counts = kernels.launch_counts()
    assert counts["variant:%s=reg" % kernel] == 2 and counts[kernel] == 2 + (
        kernel == "fused_is_pmc_step")


@pytest.mark.parametrize("case", chip_smoke.WIDE_CASES)
def test_warp_kernels_past_d128_against_plain_versions(cuda, case):
    """The six kernels that once ran a warp a particle past D = 128, all on
    the tiled engine now (fused_propose_logq and fused_transform_rng on
    their drawn products), against their float64 plain versions or, the
    random draws, on their own samples."""
    chip_smoke.wide_case(case, cuda, [])


@pytest.mark.parametrize("case", chip_smoke.DRAWN_CASES)
def test_drawn_products_past_d64_against_plain_versions(cuda, case):
    """fused_propose_logq's tiled route and fused_transform_rng's drawn
    product at K = 1 and the rule's largest K + Kt from D = 65 to 248: each
    launch counted as tiled, x and latent the looped kernel's bit for bit to
    D = 128, the seed by pointer the seed by value's, log q and log p within
    float32 tolerance of float64 and fused_logq's bit for bit, the samples'
    moments and components."""
    chip_smoke.drawn_case(case, cuda, [])


@pytest.mark.parametrize("case", chip_smoke.TILED_CASES)
def test_tiled_kernels_past_d64_against_plain_versions(cuda, case):
    """fused_maha (lower and upper operands), fused_logq and fused_rho
    (Gaussian, and Student-t with a dead component) on the tensor-core
    kernels they elect and the tiled kernels forced, counted as such,
    against their float64 plain versions, equal on a second run, fused_rho's
    log q fused_logq's bit for bit; fused_transform's tiled
    pair on components drawn by weight, its bucket pass's perm, slots and
    pos the CPU mirror's, equal to the looped kernel bit for bit to D =
    128."""
    chip_smoke.tiled_case(case, cuda, [])


@pytest.mark.parametrize("case", chip_smoke.BUCKET_CASES)
def test_tiled_bucket_layout_against_its_mirror(cuda, case):
    """The tiled products' bucket pass over all N (latents outside [0, K)
    left out): its perm, slots and pos the CPU mirror's
    (``_build.transform_tiles``) bit for bit and a second run's; to 2^18
    particles fused_transform's tiled pair on the same components (its
    moves into and out of bucket order) the looped kernel's bit for bit."""
    chip_smoke.bucket_case(case, cuda)


@pytest.mark.parametrize("case", chip_smoke.TRANSFORM_CASES[1:] + [(10, 10, 200_003, True, 44)])
def test_transform_against_plain_version(cuda, case):
    chip_smoke.transform_case(case, cuda, [])


@pytest.mark.parametrize("case", [
    # K, D, N, Student-t, dead component, seed
    (10, 10, 1 << 18, True, False, 51),
    (10, 10, 200_003, False, True, 52),
    (11, 40, 100_001, True, False, 53),
])
def test_transform_rng_distribution(cuda, case):
    chip_smoke.transform_rng_case(case, cuda, [])


@pytest.mark.parametrize("case", [
    # K, Kt, D, N, Student-t proposal, Student-t target, dead component,
    # records staged, seed: the flagship, D=40 at the widest K the rule
    # admits, the records read from device memory
    (10, 2, 10, 1 << 18, True, False, False, True, 111),
    (10, 0, 10, 200_003, False, False, True, True, 113),
    (9, 2, 40, 100_001, True, True, False, True, 118),
    (40, 2, 40, 50_001, True, False, False, False, 123),
])
def test_propose_logq_record_kernel_is_the_looped_kernel(cuda, case):
    chip_smoke.draw_variants_case(case, cuda, [])


@pytest.mark.parametrize("case", [
    # K, D, N, Student-t, dead component, records staged, seed: the
    # flagship, the K=11, D=40 route, the records read from device memory
    (10, 10, 1 << 18, True, False, True, 131),
    (11, 40, 100_001, True, False, True, 133),
    (11, 40, 100_001, False, True, True, 134),
    (40, 64, 50_001, True, False, False, 138),
])
def test_transform_rng_record_kernel_is_the_looped_kernel(cuda, case):
    chip_smoke.transform_rng_variants_case(case, cuda, [])


@pytest.mark.parametrize("case", chip_smoke.POOL_CASES)
def test_mcmc_pool_invariants(cuda, case):
    for variant in chip_smoke.pool_variants(case[1]):
        chip_smoke.pool_case(case, cuda, [], variant)


@pytest.mark.parametrize("case", chip_smoke.POOL_AGREEMENT_CASES)
def test_mcmc_pool_variants_agree_over_one_step(cuda, case):
    chip_smoke.pool_agreement_case(case, cuda, [])


@pytest.mark.parametrize("case", chip_smoke.POOL_WALK_CASES)
def test_mcmc_pool_walk_against_plain_pool(cuda, case):
    chip_smoke.pool_walk_case(case, cuda, [])


@pytest.mark.parametrize("case", chip_smoke.POOL_DISTRIBUTION_CASES)
def test_mcmc_pool_matches_plain_pool_in_distribution(cuda, case):
    chip_smoke.pool_distribution_case(case, cuda, [])


@pytest.mark.parametrize("case", [
    # K, Kt, D, N, Student-t proposal, Student-t target, dead component, seed
    (400, 2, 2, 1 << 18, True, False, False, 91),
    (200, 2, 10, 100_003, True, False, True, 92),
    (21, 2, 10, 200_003, False, True, True, 93),
    (96, 2, 40, 50_001, False, False, False, 94),
    (3, 1, 128, 50_001, False, False, False, 95),
    (10, 2, 14, 50_001, True, True, False, 97),
])
def test_blocked_kernels_against_plain_versions(cuda, case):
    chip_smoke.blocked_case(case, cuda, [])


def test_dense_and_blocked_twins(cuda):
    chip_smoke.twin_case(cuda, [])


def test_fused_logq_maps_under_vmap(cuda):
    chip_smoke.vmap_case(cuda, [])


def test_vb_iteration_against_float64_plain_version(cuda):
    from pypmc_tpu_torch.mix_adapt import GaussianInference

    data, w = chip_smoke.vb_problem(cuda, 1 << 16)
    chip_smoke.vb_reference(GaussianInference(data, components=10, weights=w, nu=11.0), [])


def test_size_gate_routes(cuda):
    chip_smoke.phase_gate(cuda, [])


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
    counts = kernels.launch_counts()
    assert counts["fused_logq"] == 1 and counts["fused_propose_logq"] == 1
    assert chip_smoke.kernel_launches(counts) == 2
    assert counts["variant:fused_propose_logq=rec"] == 1
    with pytest.raises(TypeError):
        kernels.fused_logq(xT.double(), kernels.MixtureOperands(
            ops.packed.double(), ops.K, ops.dim, ops.student_t))
    # past a kernel's own limit (the statistics kernels' D = 128) the
    # wrapper raises; fused_logq takes D = 129 through its warp kernel
    wide = core._kernel_operands(core.make_mixture(torch.zeros((1, 129), device=cuda),
                                                   torch.eye(129, device=cuda)[None])[0])
    with pytest.raises(ValueError, match="limit"):
        kernels.fused_pmc_stats(torch.zeros((129, 10), device=cuda),
                                torch.ones((10,), device=cuda), wide)
    assert kernels.fused_logq(torch.zeros((129, 10), device=cuda), wide).shape == (10,)


@pytest.mark.parametrize("K", chip_smoke.SOLVE_DOFS_K)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_solve_dofs_against_plain_version(cuda, K, dtype):
    chip_smoke.solve_dofs_case(K, getattr(torch, dtype), cuda, [])


def test_chains_as_cuda_graphs_equal_the_eager_loop(cuda):
    chip_smoke.chain_graph_cases(cuda)


def test_uncapturable_target_falls_back_to_the_eager_loop(cuda):
    chip_smoke.uncapturable_case(cuda)


@pytest.mark.parametrize("K", chip_smoke.SOLVE_DOFS_K)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_solve_dofs_warp_and_serial_kernels_equal_the_plain_version(cuda, K, dtype):
    chip_smoke.solve_dofs_variants_case(K, getattr(torch, dtype), cuda)


@pytest.mark.parametrize("case", chip_smoke.SEED_POINTER_CASES)
def test_seed_by_pointer_equals_seed_by_value(cuda, case):
    chip_smoke.seed_pointer_case(case, cuda)


@pytest.mark.parametrize("case", chip_smoke.REPLAY_CASES)
def test_replays_draw_their_seeds_particles(cuda, case):
    chip_smoke.seed_replay_case(cuda, case)


@pytest.mark.parametrize("which", [2, 3, 4, 5, 6])
def test_pmc_scan_equals_the_loop(cuda, which):
    """pmc_run_sharded(scan_steps=True) against the loop at 2^16 particles,
    pmc_sharded.py's configuration, a D=40 step past fused_propose_logq's
    rule, the D=40 pipeline's PMC stage and the 2^16 particles in float64:
    every one replayed as CUDA graphs."""
    chip_smoke.scan_case(cuda, *chip_smoke.scan_problems(cuda)[which])


@pytest.mark.parametrize("case", chip_smoke.FUSED_DRAW_CASES)
def test_fused_draws_equal_the_two_launches(cuda, case):
    chip_smoke.fused_draw_case(case, cuda, [])


@pytest.mark.parametrize("case", chip_smoke.DRAW_CASES)
def test_draw_against_plain_version(cuda, case):
    chip_smoke.draw_case(case, cuda, [])


def test_float64_entry_points_take_the_unfused_path(cuda):
    chip_smoke.float64_entry_points(cuda, [])


def test_per_point_targets_through_maha_and_rho_are_one_launch(cuda):
    chip_smoke.per_point_routes(cuda, [])
