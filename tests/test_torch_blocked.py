"""The K-blocked kernels' plain versions and routes against the JAX package.

The plain versions (float64 on the kernels' float32 inputs) against the
Pallas K-blocked kernels in interpret mode, per particle (statistics divided
by N): the Pallas kernels are float32 with ~7.5e-5 split-precision error in
their projections, so the tolerance is 5e-4, as ``tests/test_blocked_kernels.py``
holds them to the dense kernels.  The random step is held on its own
samples: its log-densities and weights against the JAX XLA path, its
statistics against the Pallas kernel on the same samples.  The routes run
in float64 against the JAX XLA updates (``fused="off"``); at these small N
the election is forced by lowering the 12 GiB budget of ``elects_blocked``,
as the JAX package's tests patch ``prefer_blocked``.  On the CPU a wrapper
runs its plain version, so a route is read from spies on the wrappers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pypmc_tpu.density.core as jcore
import pypmc_tpu.mix_adapt.pmc as jpmc
import pypmc_tpu.ops.pallas_kernels as pk
from pypmc_tpu.mix_adapt import variational as jvb
import pypmc_tpu_torch
from pypmc_tpu_torch.density import core
from pypmc_tpu_torch.mix_adapt import pmc
from pypmc_tpu_torch.mix_adapt import variational as tvb
from pypmc_tpu_torch.ops import kernels

torch.set_num_threads(1)

TOL_PALLAS = 5e-4
RTOL64, ATOL64 = 1e-8, 1e-10


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port runs on the card unless the CPU is asked for: ask for it."""
    with pypmc_tpu_torch.using_device("cpu"):
        yield


@pytest.fixture()
def interpret(monkeypatch):
    monkeypatch.setattr(pk, "INTERPRET", True)


def chunked(monkeypatch, chunk, D, N):
    """Make the plain K-blocked versions walk ``chunk`` components at a time
    over ``N`` particles of dimension ``D``."""
    monkeypatch.setattr(kernels, "_PLAIN_CHUNK_ELEMENTS", chunk * D * N)


def mixture(rng, K, D, student_t, dead=False, dtype=np.float64, spread=2.0):
    means = rng.normal(0, spread, (K, D))
    a = rng.normal(0, 0.3, (K, D, D))
    covs = np.eye(D)[None] + np.einsum("kij,klj->kil", a, a)
    w = rng.uniform(0.5, 1.5, K)
    if dead:
        w[K // 2] = 0.0
    dofs = rng.uniform(3, 12, K) if student_t else None
    cast = lambda v: None if v is None else v.astype(dtype)
    jp, valid = jcore.make_mixture(cast(means), cast(covs), cast(w / w.sum()), cast(dofs))
    assert bool(np.asarray(valid).all())
    return jp, core.params_from_numpy(jp)


def per_particle(got, ref, n, what):
    np.testing.assert_allclose(np.asarray(got) / n, np.asarray(ref) / n, rtol=TOL_PALLAS,
                               atol=TOL_PALLAS, err_msg=what)


def pallas_stats(jp, xT, w, dof_stats):
    a2, b2, ln, wk, dof, _ = jcore._pallas_operands(jp, "inv_chol")
    psi = (jax.scipy.special.digamma(0.5 * (jp.dim + jp.dof)).reshape(jp.K, 1)
           if dof_stats else None)
    return pk.fused_pmc_stats_blocked(jnp.asarray(xT), jnp.asarray(w), a2, b2, ln, wk, dof,
                                      psi, dim=jp.dim, dof_stats=dof_stats)


def ops64(tp):
    ops = core._kernel_operands(tp)
    return kernels.MixtureOperands(ops.packed.double(), ops.K, ops.dim, ops.student_t)


# ------------------------------------------------------------------ #
# plain versions against the Pallas kernels (interpret mode)         #
# ------------------------------------------------------------------ #

BLOCKED_SHAPES = [
    # K, D, Student-t, dead component, components a chunk of the plain version
    (21, 10, False, True, 8),       # K not a chunk multiple (8, 8, 5)
    (21, 10, True, True, 8),
    (400, 2, False, False, 48),     # the mixture-reduction scale
    (400, 2, True, False, 48),
    (64, 40, False, False, 24),
]


@pytest.mark.parametrize("K,D,student_t,dead,chunk", BLOCKED_SHAPES)
def test_plain_pmc_stats_blocked_matches_pallas(interpret, monkeypatch, K, D, student_t, dead,
                                                chunk):
    rng = np.random.default_rng(K + D)
    N = 768
    chunked(monkeypatch, chunk, D, N)
    jp, tp = mixture(rng, K, D, student_t, dead, dtype=np.float32)
    xT = rng.normal(0, 2, (D, N)).astype(np.float32)
    w = rng.exponential(1.0, N).astype(np.float32)
    ref = pallas_stats(jp, xT, w, student_t)
    got = kernels.plain_pmc_stats_blocked(torch.tensor(xT).double(), torch.tensor(w).double(),
                                          ops64(tp), student_t)
    for key in ("s0", "s0c", "sd", "g", "sw", "t1"):
        per_particle(got[key].numpy(), ref[key], N, key)
    if dead:
        assert float(got["s0"][K // 2]) == 0.0
    # the chunks change only the order of the sums: the dense plain version
    dense = kernels.plain_pmc_stats(torch.tensor(xT).double(), torch.tensor(w).double(),
                                    ops64(tp), student_t)
    for key in dense:
        torch.testing.assert_close(got[key], dense[key], rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("K,D,chunk", [(21, 10, 8), (400, 2, 48), (64, 40, 24)])
@pytest.mark.parametrize("zero_weights", [False, True])
def test_plain_vb_estep_blocked_matches_pallas(interpret, monkeypatch, K, D, chunk,
                                               zero_weights):
    rng = np.random.default_rng(3 + K)
    N = 768
    chunked(monkeypatch, chunk, D, N)
    m = rng.normal(0, 2, (K, D)).astype(np.float32)
    a = rng.normal(0, 0.2, (K, D, D))
    W = np.eye(D)[None] * 0.5 + np.einsum("kij,klj->kil", a, a)
    nu = rng.uniform(D + 1, D + 20, K)
    A = (np.sqrt(nu)[:, None, None]
         * np.transpose(np.linalg.cholesky(W), (0, 2, 1))).astype(np.float32)
    const = rng.normal(0, 1, K).astype(np.float32)
    xT = (m[rng.integers(0, K, N)].T + rng.normal(0, 1, (D, N))).astype(np.float32)
    w = rng.uniform(0, 1, N).astype(np.float32)
    if zero_weights:
        w[::3] = 0.0
    b2 = np.einsum("kid,kd->ki", A, m).reshape(K * D, 1)
    ref = pk.fused_vb_estep_blocked(jnp.asarray(xT), jnp.asarray(w),
                                    jnp.asarray(A.reshape(K * D, D)), jnp.asarray(b2),
                                    jnp.asarray(const.reshape(K, 1)), dim=D)
    args = [torch.tensor(v).double() for v in (xT, w, A, m, const)]
    got = kernels.plain_vb_estep_blocked(*args)
    for name, g, r in zip(("N_comp", "sd", "g", "log_q_Z"), got, ref):
        per_particle(g.numpy(), r, N, name)
    for g, d in zip(got, kernels.plain_vb_estep(*args)):
        torch.testing.assert_close(g, d, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("K,D,student_t,chunk", [(21, 10, True, 8), (400, 2, False, 48),
                                                 (64, 40, False, 24)])
def test_plain_step_blocked_on_its_own_samples(interpret, monkeypatch, K, D, student_t, chunk):
    """The plain K-blocked step draws the plain dense step's particles from
    the same seed words; its weights match the JAX XLA log-densities on
    them, its statistics the Pallas K-blocked kernel on them."""
    rng = np.random.default_rng(11 + K)
    n = 1024
    chunked(monkeypatch, chunk, D, n)
    jp, tp = mixture(rng, K, D, student_t, dead=True, dtype=np.float32, spread=1.0)
    jt, tt = mixture(rng, 2, D, False, dtype=np.float32, spread=1.0)
    xT, lat, w, stats = kernels.plain_is_pmc_step_blocked((5, 6), ops64(tp), ops64(tt), n,
                                                           student_t)
    dense = kernels.plain_is_pmc_step((5, 6), ops64(tp), ops64(tt), n, student_t)
    assert torch.equal(xT, dense[0]) and torch.equal(lat, dense[1])
    assert not (lat == K // 2).any()       # the dead component is never drawn
    # the JAX XLA log-densities of the float32 mixtures on the samples
    x = jnp.asarray(xT.numpy().astype(np.float32))
    w_ref = np.exp(np.asarray(jcore.mixture_logpdf_T(jt, x), np.float64)
                   - np.asarray(jcore.mixture_logpdf_T(jp, x), np.float64))
    np.testing.assert_allclose(w.numpy(), w_ref, rtol=2e-3)
    ref = pallas_stats(jp, xT.numpy().astype(np.float32), w.numpy().astype(np.float32),
                       student_t)
    for key in ("s0", "s0c", "sd", "g", "t1"):
        per_particle(stats[key].numpy(), ref[key], n, key)
    per_particle(stats["sw"][:2].numpy(), ref["sw"], n, "sw")
    np.testing.assert_allclose(float(stats["sw"][2]),
                               float(np.sum(w.numpy() * np.log(w.numpy()))), rtol=1e-10)


# ------------------------------------------------------------------ #
# routes                                                              #
# ------------------------------------------------------------------ #

class Spy:
    """Counts the calls of the dense and the K-blocked wrapper of a kernel."""

    def __init__(self, monkeypatch, kernel):
        self.calls = {"dense": 0, "blocked": 0}
        for mode, name in (("dense", kernel), ("blocked", kernel + "_blocked")):
            fn = getattr(kernels, name)

            def spy(*args, _fn=fn, _mode=mode, **kwargs):
                self.calls[_mode] += 1
                return _fn(*args, **kwargs)

            monkeypatch.setattr(kernels, name, spy)


@pytest.mark.parametrize("hbm,K,want", [(0, 80, "blocked"), (None, 80, None), (0, 4, "dense")])
def test_pmc_update_route(monkeypatch, hbm, K, want):
    """K=80, D=2 (K*D > 128) runs the K-blocked statistics where the budget
    elects them and the unfused update otherwise, counted as
    plain:fused_pmc_stats; K=4 runs the dense kernel.  Every route matches
    the JAX XLA update in float64."""
    if hbm is not None:
        monkeypatch.setattr(kernels, "_BLOCKED_HBM", hbm)
    D, N = 2, 2048
    assert kernels.elects_blocked("fused_pmc_stats", K, D, N) == (hbm == 0)
    rng = np.random.default_rng(21)
    jp, tp = mixture(rng, K, D, True, dead=True)
    x = rng.normal(0, 2.5, (D, N))
    w = rng.exponential(1.0, N)
    spy = Spy(monkeypatch, "fused_pmc_stats")
    kernels.reset_launch_counts()
    got = pmc.pmc_update(tp, torch.tensor(x), torch.tensor(w), transposed=True)
    assert spy.calls == {"dense": int(want == "dense"), "blocked": int(want == "blocked")}
    assert kernels.launch_counts()["plain:fused_pmc_stats"] == int(want is None)
    assert (got.rho is None) == (want is not None)
    ref = jpmc.pmc_update(jp, jnp.asarray(x), jnp.asarray(w), transposed=True, fused="off")
    for f, v in core.params_to_numpy(got.params).items():
        if v is not None:
            np.testing.assert_allclose(v, np.asarray(getattr(ref.params, f)), rtol=RTOL64,
                                       atol=ATOL64, err_msg=f)


def test_step_route_and_update(monkeypatch):
    """K=40, D=4 with a 2-component target: the step takes the K-blocked
    kernel where elected (the K + K_target VMEM rule), draws the particles
    of the two-pass route from the same seed, and its update matches the JAX
    XLA update on its own samples."""
    rng = np.random.default_rng(22)
    K, D, n = 40, 4, 4096
    jp, tp = mixture(rng, K, D, False, dead=True)
    _, tt = mixture(rng, 2, D, False)
    spy = Spy(monkeypatch, "fused_is_pmc_step")
    kernels.reset_launch_counts()
    off = pmc.pmc_step_mixture_target(tp, tt, 4, n)
    assert spy.calls == {"dense": 0, "blocked": 0}
    assert kernels.launch_counts()["plain:fused_is_pmc_step"] == 1
    monkeypatch.setattr(kernels, "_BLOCKED_HBM", 0)
    result, xT, w, latent, sw = pmc.pmc_step_mixture_target(tp, tt, 4, n)
    assert spy.calls == {"dense": 0, "blocked": 1}
    torch.testing.assert_close(xT, off[1], rtol=0, atol=0)
    torch.testing.assert_close(w, off[2], rtol=1e-12, atol=0)
    torch.testing.assert_close(sw, off[4], rtol=1e-10, atol=0)
    ref = jpmc.pmc_update(jp, jnp.asarray(xT.numpy()), jnp.asarray(w.numpy()),
                          transposed=True, fused="off", dof_solver_steps=0)
    for f in ("means", "cov", "weights"):
        np.testing.assert_allclose(getattr(result.params, f).numpy(),
                                   np.asarray(getattr(ref.params, f)), rtol=RTOL64,
                                   atol=ATOL64, err_msg=f)
    assert float(result.params.weights[K // 2]) == 0.0


def test_gaussian_inference_route(monkeypatch):
    """K=80, D=2: the E-step takes the K-blocked kernel where elected, and
    the port's iterations match the JAX package's XLA iterations."""
    rng = np.random.default_rng(23)
    K, D, N = 80, 2, 2048
    data = rng.normal(0, 1, (N, D)) + rng.integers(0, 3, (N, 1)) * 3.0
    weights = np.abs(rng.normal(1, 0.2, N))
    monkeypatch.setattr(kernels, "_BLOCKED_HBM", 0)
    spy = Spy(monkeypatch, "fused_vb_estep")
    t = tvb.GaussianInference(data, components=K, weights=weights)
    j = jvb.GaussianInference(data, components=K, weights=weights)
    assert t._fused_eligible() == "blocked" and spy.calls == {"dense": 0, "blocked": 1}
    for _ in range(3):
        np.testing.assert_allclose(t._update_with_bound(), j._update_with_bound(),
                                   rtol=RTOL64)
    assert spy.calls == {"dense": 0, "blocked": 4}
    for f in ("N_comp", "x_mean_comp", "S", "alpha", "m", "W"):
        np.testing.assert_allclose(tvb._host(getattr(t, f)), np.asarray(getattr(j, f)),
                                   rtol=RTOL64, atol=ATOL64, err_msg=f)


# ------------------------------------------------------------------ #
# twins: dense and K-blocked where both run                           #
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("student_t", [True, False])
def test_dense_and_blocked_twins(student_t):
    """At K=12, D=10, Kt=2 (K*D = 120: both kernels take it) a forced
    "dense" and a forced "blocked" step draw the same particles from one
    seed and give the same update; so do the two pmc_update routes and the
    two VB E-step statistics."""
    rng = np.random.default_rng(24)
    _, tp = mixture(rng, 12, 10, student_t, dead=True)
    _, tt = mixture(rng, 2, 10, False)
    a = pmc.pmc_step_mixture_target(tp, tt, 7, 3001, fused="dense")
    b = pmc.pmc_step_mixture_target(tp, tt, 7, 3001, fused="blocked")
    assert torch.equal(a[1], b[1]) and torch.equal(a[3], b[3])
    for i in (2, 4):
        torch.testing.assert_close(a[i], b[i], rtol=1e-12, atol=0)
    for f in ("means", "cov", "weights"):
        torch.testing.assert_close(getattr(a[0].params, f), getattr(b[0].params, f),
                                   rtol=1e-10, atol=1e-12)
    x, w = a[1], a[2]
    ud = pmc.pmc_update(tp, x, w, transposed=True, fused="dense")
    ub = pmc.pmc_update(tp, x, w, transposed=True, fused="blocked")
    for f in ("means", "cov", "weights"):
        torch.testing.assert_close(getattr(ud.params, f), getattr(ub.params, f),
                                   rtol=1e-10, atol=1e-12)
    A = torch.linalg.cholesky(tp.inv_sigma).transpose(1, 2).contiguous()
    const = torch.log(tp.weights.clamp_min(1e-3)) - 0.5 * tp.log_det
    dense = kernels.fused_vb_estep(x, w, A, tp.means, const)
    blocked = kernels.fused_vb_estep_blocked(x, w, A, tp.means, const)
    for d, bl in zip(dense, blocked):
        torch.testing.assert_close(d, bl, rtol=1e-10, atol=1e-12)


def test_blocked_limits_are_stated():
    """The K-blocked kernels walk any K in chunks: only D limits them.  Up
    to D = 16 the register pass takes 16 components a chunk (4 past D =
    10); past D = 16 the chunk is the largest that lets two blocks share an
    SM where one component fits that budget."""
    from pypmc_tpu_torch.ops import _build

    # the register pass's plan: kc, operands staged, shared memory a block
    # (records | tile of 64 columns at stride 72 | float64 accumulators)
    pinned = {(200, 10): (16, True, 4 * (16 * 88 + 16 * 13 * 72) + 8 * (16 * 68 + 3)),
              (400, 2): (16, True, 4 * (16 * 16 + 16 * 5 * 72) + 8 * (16 * 8 + 3)),
              (10, 14): (4, True, _build.smem_bytes("fused_pmc_stats_blocked", 10, 14))}
    for (K, D), plan in pinned.items():
        for kernel in ("fused_pmc_stats_blocked", "fused_is_pmc_step_blocked"):
            assert _build.blocked_plan(kernel, K, D) == plan, (kernel, K, D)
        vb = _build.blocked_plan("fused_vb_estep_blocked", K, D)
        assert vb[:2] == plan[:2] and vb[2] <= _build.SMEM_LIMIT
    # three blocks of the K=200, D=10 statistics pass share an SM's 228 KB
    assert 3 * (_build.blocked_plan("fused_is_pmc_step_blocked", 200, 10)[2] + 1024) <= 228 * 1024
    # the step's first launch stages both mixtures' records and cumw, never L
    assert _build.draw_smem_bytes(200, 2, 10) == 4 * (202 * 88 + 200)
    assert 2 * (_build.draw_smem_bytes(200, 2, 10) + 1024) <= 228 * 1024
    assert _build.draw_smem_bytes(96, 2, 40) == 0 and _build.draw_smem_bytes(2000, 2, 10) == 0
    for kernel in _build.BLOCKED:
        for K, D in ((400, 2), (200, 10), (96, 40), (12, 10), (5000, 2), (3, 128)):
            assert _build.limit_reason(kernel, K, D, 2) is None, (kernel, K, D)
            kc, staged, smem = _build.blocked_plan(kernel, K, D)
            assert 1 <= kc <= K and smem <= _build.SMEM_LIMIT
            assert smem == _build.smem_bytes(kernel, K, D, 2)
        assert _build.blocked_plan(kernel, 400, 2)[2] <= _build._HALF_SMEM
        assert _build.blocked_plan(kernel, 400, 2)[0] < 400
        assert _build.blocked_plan(kernel, 3, 128)[1] is False   # operands in device memory
        with pytest.raises(ValueError, match="D <= 128"):
            _build.check_limits(kernel, 4, 129, 2)
