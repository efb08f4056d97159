"""propose_T's draw and transform in one call, against the two it replaces.

Up to D = 64, where the transform of ``density.core.propose_T``'s route is a
record kernel, the port draws and transforms in one launch:
``ops.kernels.fused_draw_transform`` (kernel ``csrc/draw.cu``) where the
route is ``fused_transform``, ``fused_draw_transform_rng`` where it is
``fused_transform_rng``.  Each plain version is the composition it
replaces, so the CPU draws are the same bit for bit as before, and the
route still agrees with the JAX package's ``propose_T`` in distribution
(``tests/test_torch_draw.py``).  The route decision is evaluated here for
the card's operands; the kernels' bit equality with the two launches is
held on the card by ``tests/test_torch_kernels_gpu.py`` and
``chip_smoke.py``.
"""

import jax  # noqa: F401  (the JAX package's modules import it)
import numpy as np
import pytest
import torch

import pypmc_tpu.density.core as jcore
import pypmc_tpu_torch
from pypmc_tpu_torch import _rng
from pypmc_tpu_torch.density import core
from pypmc_tpu_torch.ops import _build, kernels

torch.set_num_threads(1)

CARD32, CARD64 = ("cuda", torch.float32), ("cuda", torch.float64)


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port runs on the card unless the CPU is asked for: ask for it."""
    with pypmc_tpu_torch.using_device("cpu"):
        yield


def mixture(K, D, student_t, dead, dtype=np.float32, seed=0):
    """A K-component mixture made by the JAX package from numpy draws: a
    dead middle and (K > 2) a dead trailing component where ``dead``."""
    rng = np.random.default_rng(seed + 17 * K + D)
    means = rng.normal(0, 3, (K, D))
    a = rng.normal(0, 0.3, (K, D, D))
    covs = np.eye(D)[None] + np.einsum("kij,klj->kil", a, a)
    w = rng.uniform(0.5, 1.5, K)
    if dead:
        w[K // 2] = 0.0
        if K > 2:
            w[-1] = 0.0
    dofs = rng.uniform(3, 9, K) if student_t else None
    cast = lambda v: None if v is None else v.astype(dtype)
    jp, valid = jcore.make_mixture(cast(means), cast(covs), cast(w / w.sum()), cast(dofs))
    assert bool(np.asarray(valid).all())
    return core.params_from_numpy(jp)


def two_calls(name, params, seed, n):
    """What propose_T called before the fusion: draw_proposal_inputs on its
    thresholds and dofs, then fused_transform on the normals and scales, or
    fused_transform_rng keyed by the words with bit 0 of the second
    flipped."""
    cumw = core._cumulative_weights(params.weights).contiguous()
    dof = None if params.dof is None else params.dof.contiguous()
    ops = core._kernel_operands(params)
    if name == "fused_draw_transform":
        latent, zT, scale = kernels.draw_proposal_inputs(seed, cumw, dof, n, params.dim, True)
        return kernels.fused_transform(zT, latent, scale, ops), latent
    latent = kernels.draw_proposal_inputs(seed, cumw, dof, n, params.dim, False)[0]
    return kernels.fused_transform_rng(_rng.flip_bit(seed, 0), latent, ops), latent


FUSED = ("fused_draw_transform", "fused_draw_transform_rng")
# K, Student-t, dead components
MIXTURES = [(1, True, False), (1, False, False), (4, True, True), (4, False, True),
            (3, True, False), (7, False, False)]


@pytest.mark.parametrize("name", FUSED)
@pytest.mark.parametrize("D", [2, 10, 40])
@pytest.mark.parametrize("K,student_t,dead", MIXTURES)
def test_plain_version_is_the_composition_it_replaces(name, D, K, student_t, dead):
    """Each fused draw's plain version equals the two calls it replaces bit
    for bit, xT and latent, with the seed as a tuple and as a tensor; its
    latent never names a dead component."""
    params = mixture(K, D, student_t, dead)
    ops = core._kernel_operands(params)
    for seed in ((5, 9), torch.tensor((5, 9), dtype=torch.int64)):
        got = getattr(kernels, name)(seed, ops, 1500)
        ref = two_calls(name, params, seed, 1500)
        assert got[1].dtype == torch.int32 and tuple(got[0].shape) == (D, 1500)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    w = params.weights.numpy()
    assert np.all(np.bincount(got[1].numpy(), minlength=K)[w == 0] == 0)


@pytest.mark.parametrize("name", FUSED)
def test_plain_version_in_float64(name):
    """The plain versions take float64 operands as the calls they replace
    do (the CPU's float64 propose_T)."""
    params = mixture(3, 5, True, True, np.float64)
    got = getattr(kernels, name)((2, 3), core._kernel_operands(params), 2000)
    ref = two_calls(name, params, (2, 3), 2000)
    assert got[0].dtype == torch.float64
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("name", FUSED)
def test_seeds_draw_their_own_particles(name):
    """One seed one draw, another seed another."""
    ops = core._kernel_operands(mixture(4, 6, True, False))
    a, b, c = (getattr(kernels, name)(s, ops, 800) for s in ((1, 2), (1, 2), (1, 3)))
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0], c[0])


@pytest.mark.parametrize("K,D,student_t,dead", [(11, 40, True, False), (16, 40, False, True),
                                                (3, 10, True, True), (1, 2, False, False),
                                                (12, 64, True, False)])
def test_propose_T_draws_as_before(K, D, student_t, dead):
    """propose_T on the CPU gives the particles and components of the two
    calls its route made before the fusion, bit for bit (the route's
    transform: fused_transform_rng where it fits at 1024 particles a tile,
    else fused_transform)."""
    params = mixture(K, D, student_t, dead)
    n = 2048
    route = kernels.proposal_route(K, D, n)
    assert route in FUSED
    xT, latent = core.propose_T(params, (8, 13), n)
    ref = two_calls(route, params, (8, 13), n)
    assert torch.equal(xT, ref[0]) and torch.equal(latent, ref[1])


# (K, D, n, operands) -> propose_T's route on the card
ROUTES = [
    ((11, 40, 1 << 20, CARD32), "fused_draw_transform_rng"),
    ((32, 40, 1 << 20, CARD32), "fused_draw_transform"),    # the D=40 pipeline's PMC draws
    ((10, 10, 1 << 22, CARD32), "fused_draw_transform_rng"),
    ((33, 40, 4096, CARD32), "fused_draw_transform"),
    ((40, 40, 4096, CARD32), "fused_draw_transform"),       # its records in device memory
    ((13, 64, 1024, CARD32), "fused_draw_transform"),
    ((4, 80, 1 << 18, CARD32), "fused_transform_rng"),      # past D = 64: two launches
    ((16, 80, 1 << 18, CARD32), "fused_transform"),
    ((1, 129, 4096, CARD32), "fused_transform_rng"),
    ((32, 40, 1 << 20, CARD64), None),                      # float64: the tensor transform
    ((11, 40, 1 << 20, CARD64), None),
    ((32, 40, 1000, CARD32), None),                         # n < 1024: the tensor transform
    ((11, 40, 1023, CARD32), None),
]


@pytest.mark.parametrize("shape,route", ROUTES)
def test_proposal_route_on_the_card(shape, route):
    """The route propose_T takes for the card's operands: the fused draws
    where the JAX package's transform route is a record kernel (D <= 64,
    float32, n >= 1024), the two launches past D = 64, the tensor transform
    for float64 and below 1024 particles; each refusal counted as the gates
    count it."""
    K, D, n, like = shape
    kernels.reset_launch_counts()
    assert kernels.proposal_route(K, D, n, like=like) == route
    counts = {c: v for c, v in kernels.launch_counts().items() if v}
    want = {}
    if route not in ("fused_transform_rng", "fused_draw_transform_rng"):
        want["plain:fused_transform_rng"] = 1
    if route is None:
        want["plain:fused_transform"] = 1
    assert counts == want
    # on the CPU the decision is the shape's: float32's on the card
    assert kernels.proposal_route(K, D, n, like=("cpu", like[1])) == kernels.proposal_route(
        K, D, n, like=CARD32)


# (K, D) -> (kernel, records staged, a record's floats, threads, shared
# memory a block), worked by hand: the draw records (D + D (D + 1) / 2) | 1
# floats, then the K thresholds and K dofs, staged where K (record + 2) x 4
# bytes fit half an SM (115,712 B)
PLANS = {
    (10, 10): ("rec", True, 65, 256, 4 * 10 * 67),
    (11, 40): ("rec", True, 861, 256, 4 * 11 * 863),
    (32, 40): ("rec", True, 861, 256, 4 * 32 * 863),
    (33, 40): ("rec", True, 861, 256, 113_916),
    (34, 40): ("rec", False, 861, 256, 0),
    (13, 64): ("rec", True, 2145, 256, 111_644),
    (14, 64): ("rec", False, 2145, 256, 0),
    (1, 1): ("rec", True, 3, 256, 4 * 1 * 5),
}


@pytest.mark.parametrize("K,D", sorted(PLANS))
def test_draw_transform_plan(K, D):
    assert _build.draw_transform_plan(K, D) == PLANS[(K, D)]


@pytest.mark.parametrize("name", FUSED)
@pytest.mark.parametrize("D", [65, 129])
def test_fused_draws_raise_past_their_record_kernel(name, D):
    """Past D = 64 there is no fused kernel: the wrapper raises on any
    device, naming the route propose_T takes there."""
    ops = core._kernel_operands(mixture(1, D, False, False))
    with pytest.raises(ValueError, match="draw_proposal_inputs"):
        getattr(kernels, name)((1, 2), ops, 10)
