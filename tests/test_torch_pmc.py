"""pypmc_tpu_torch.mix_adapt.pmc against pypmc_tpu.mix_adapt.pmc in float64
on identical inputs (the JAX XLA path, ``fused="off"``), and the fused step
against a mixture target in distribution."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax
import pypmc_tpu.density.core as jcore
import pypmc_tpu.mix_adapt.pmc as jpmc
import pypmc_tpu.ops.pallas_kernels as pk
import pypmc_tpu_torch
from pypmc_tpu_torch.density import core
from pypmc_tpu_torch.mix_adapt import pmc
from pypmc_tpu_torch.ops import kernels

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port runs on the card unless the CPU is asked for: ask for it."""
    with pypmc_tpu_torch.using_device("cpu"):
        yield

RTOL64, ATOL64 = 1e-10, 1e-12


def mixture(rng, K, D, student_t, dead=False):
    means = rng.normal(0, 2, (K, D))
    a = rng.normal(0, 0.4, (K, D, D))
    covs = np.eye(D)[None] + np.einsum("kij,klj->kil", a, a)
    w = rng.uniform(0.5, 1.5, K)
    if dead:
        w[K // 2] = 0.0
    dofs = rng.uniform(4, 12, K) if student_t else None
    jp, _ = jcore.make_mixture(means, covs, w / w.sum(), dofs)
    return jp, core.params_from_numpy(jp)


def assert_params_close(got, ref, rtol=RTOL64, atol=ATOL64):
    for f, v in core.params_to_numpy(got).items():
        r = getattr(ref, f)
        if v is None:
            assert r is None
            continue
        np.testing.assert_allclose(v, np.asarray(r), rtol=rtol, atol=atol, err_msg=f)


def test_calculate_rho_rb_matches_jax():
    rng = np.random.default_rng(0)
    jp, tp = mixture(rng, 4, 3, True, dead=True)
    x = rng.normal(0, 3, (500, 3))
    ref = np.asarray(jpmc.calculate_rho_rb_T(jp, jnp.asarray(x.T)))
    got = pmc.calculate_rho_rb_T(tp, torch.tensor(x.T.copy())).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL64, atol=ATOL64)
    assert np.all(got[2] == 0)
    np.testing.assert_allclose(pmc.calculate_rho_rb(tp, torch.tensor(x)).numpy(), ref.T,
                               rtol=RTOL64, atol=ATOL64)


@pytest.mark.parametrize("fused", ["auto", "off"])
@pytest.mark.parametrize("student_t,dead,rb,mincount", [
    (False, False, True, 0), (True, False, True, 0), (True, True, True, 0),
    (False, False, False, 0), (True, False, False, 60)])
def test_pmc_update_matches_jax(student_t, dead, rb, mincount, fused):
    """``fused="auto"`` on the CPU runs the plain version of fused_pmc_stats
    (whitened statistics); ``"off"`` the unfused path.  Both must match the
    JAX XLA path."""
    if fused == "auto" and not rb:
        fused = "off"      # the fused statistics are Rao-Blackwellized only
    rng = np.random.default_rng(1)
    K, D, N = 4, 3, 2000
    jp, tp = mixture(rng, K, D, student_t, dead)
    x = rng.normal(0, 2.5, (D, N))
    w = rng.exponential(1.0, N)
    latent = rng.choice(K, size=N, p=np.asarray(jp.weights)).astype(np.int32)
    ref = jpmc.pmc_update(jp, jnp.asarray(x), jnp.asarray(w), jnp.asarray(latent),
                          rb=rb, mincount=mincount, transposed=True, fused="off")
    got = pmc.pmc_update(tp, torch.tensor(x), torch.tensor(w), torch.tensor(latent),
                         rb=rb, mincount=mincount, transposed=True, fused=fused)
    assert_params_close(got.params, ref.params)
    np.testing.assert_array_equal(got.live.numpy(), np.asarray(ref.live))
    np.testing.assert_array_equal(got.updated_ok.numpy(), np.asarray(ref.updated_ok))
    if dead:
        assert float(got.params.weights[K // 2]) == 0.0


def test_pmc_update_unweighted_row_major():
    rng = np.random.default_rng(2)
    jp, tp = mixture(rng, 3, 2, False)
    x = rng.normal(0, 2, (700, 2))
    ref = jpmc.pmc_update(jp, jnp.asarray(x), fused="off")
    got = pmc.pmc_update(tp, torch.tensor(x))
    assert_params_close(got.params, ref.params)
    # 700 particles: below 1024 the update takes the unfused path, as the
    # JAX package's does (pmc.py:223), and forms the responsibilities
    assert got.rho is not None and got.rho.shape == (3, 700)


def test_solve_dofs_matches_jax():
    const = np.array([-0.3, -0.02, -1e-4, 0.5, -5.0])
    old = np.array([3.0, 4.0, 5.0, 6.0, 7.0])
    ref = np.asarray(jpmc._solve_dofs(jnp.asarray(const), jnp.asarray(old), 100,
                                      1e-5, 1e3, jnp.float64))
    got = kernels.solve_dofs(torch.tensor(const), torch.tensor(old), 100, 1e-5, 1e3).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL64, atol=ATOL64)
    assert got[3] == 1e3      # no sign change: clamped to the interval end


def test_fused_arguments():
    """A forced "blocked" runs the K-blocked route (its plain version here)
    and matches the dense one; past the JAX package's VMEM fit of the
    K-blocked kernel (D=128) it raises naming the rule, as a forced "dense"
    past its rule does."""
    rng = np.random.default_rng(3)
    _, tp = mixture(rng, 2, 2, False)
    _, tt = mixture(rng, 2, 2, False)
    x = torch.tensor(rng.normal(size=(2, 50)))
    with pytest.raises(ValueError, match="fused must be"):
        pmc.pmc_update(tp, x, transposed=True, fused="fast")
    blocked = pmc.pmc_update(tp, x, transposed=True, fused="blocked")
    dense = pmc.pmc_update(tp, x, transposed=True, fused="dense")
    assert blocked.rho is None
    assert_params_close(blocked.params, dense.params)
    with pytest.raises(ValueError, match="infeasible"):
        pmc.pmc_update(tp, x, latent=torch.zeros(50, dtype=torch.int32), rb=False,
                       transposed=True, fused="dense")
    step_b = pmc.pmc_step_mixture_target(tp, tt, 0, 100, fused="blocked")
    step_d = pmc.pmc_step_mixture_target(tp, tt, 0, 100, fused="dense")
    torch.testing.assert_close(step_b[1], step_d[1], rtol=0, atol=0)
    _, wide = mixture(rng, 1, 128, False)
    _, wide_t = mixture(rng, 1, 128, False)
    xw = torch.tensor(rng.normal(size=(128, 50)))
    with pytest.raises(ValueError, match="VMEM fit of the K-blocked kernel"):
        pmc.pmc_update(wide, xw, transposed=True, fused="blocked")
    with pytest.raises(ValueError, match="VMEM fit of the K-blocked kernel"):
        pmc.pmc_step_mixture_target(wide, wide_t, 0, 100, fused="blocked")


@pytest.mark.parametrize("student_t", [True, False])
def test_step_mixture_target_fused_matches_two_pass(student_t):
    """The plain fused step and the two-pass composition (``fused="off"``)
    draw the same particles from the same seed, so their updates agree."""
    rng = np.random.default_rng(4)
    _, tp = mixture(rng, 3, 4, student_t, dead=True)
    _, tt = mixture(rng, 2, 4, False)
    a = pmc.pmc_step_mixture_target(tp, tt, 9, 4001)
    b = pmc.pmc_step_mixture_target(tp, tt, 9, 4001, fused="off")
    torch.testing.assert_close(a[1], b[1], rtol=0, atol=0)
    torch.testing.assert_close(a[2], b[2], rtol=1e-12, atol=0)
    torch.testing.assert_close(a[4], b[4], rtol=1e-10, atol=0)
    for f in ("means", "cov", "weights"):
        torch.testing.assert_close(getattr(a[0].params, f), getattr(b[0].params, f),
                                   rtol=1e-8, atol=1e-10)
    # the dead component is never drawn and stays dead
    assert not (a[3] == 1).any()
    assert float(a[0].params.weights[1]) == 0.0


def test_pmc_log_likelihood_matches_jax():
    rng = np.random.default_rng(5)
    jp, tp = mixture(rng, 3, 3, True)
    x = rng.normal(0, 2, (3, 333))
    w = rng.dirichlet(np.ones(333))
    for nw in (None, w):
        ref = float(jpmc.pmc_log_likelihood(jp, jnp.asarray(x), None if nw is None
                                            else jnp.asarray(nw), transposed=True))
        got = float(pmc.pmc_log_likelihood(tp, torch.tensor(x), None if nw is None
                                           else torch.tensor(nw), transposed=True))
        np.testing.assert_allclose(got, ref, rtol=RTOL64, atol=ATOL64)


# ------------------------------------------------------------------ #
# the size gate: the port takes its unfused path where JAX takes XLA   #
# ------------------------------------------------------------------ #

def test_pmc_update_past_the_kernel_limit_takes_the_unfused_path():
    """K=30, D=10 is past the single-pass kernel's K*D <= 128, where the JAX
    package takes its XLA update: "auto" takes the unfused update (through
    fused_rho and fused_maha, their plain versions here), returns rho, and
    matches the JAX XLA update; a forced "dense" raises naming the rule, as
    the JAX package's does."""
    from pypmc_tpu_torch.ops import kernels

    rng = np.random.default_rng(6)
    K, D, N = 30, 10, 3000
    jp, tp = mixture(rng, K, D, True)
    x = rng.normal(0, 2.5, (D, N))
    w = rng.exponential(1.0, N)
    assert not kernels.fits("fused_pmc_stats", K, D)
    kernels.reset_launch_counts()
    got = pmc.pmc_update(tp, torch.tensor(x), torch.tensor(w), transposed=True)
    assert kernels.launch_counts()["plain:fused_pmc_stats"] == 1
    ref = jpmc.pmc_update(jp, jnp.asarray(x), jnp.asarray(w), transposed=True, fused="off")
    assert_params_close(got.params, ref.params)
    np.testing.assert_allclose(got.rho.numpy(), np.asarray(ref.rho), rtol=RTOL64, atol=ATOL64)
    with pytest.raises(ValueError, match=r"K\*D <= 128"):
        pmc.pmc_update(tp, torch.tensor(x), torch.tensor(w), transposed=True, fused="dense")
    with pytest.raises(ValueError, match=r"K\*D <= 128"):
        jpmc.pmc_update(jp, jnp.asarray(x), jnp.asarray(w), transposed=True, fused="dense")


def test_step_past_the_kernel_limit_composes_two_passes():
    """fused_is_pmc_step does not take K=30, D=10 either: the step draws
    with fused_propose_logq (which fits) and updates unfused; the update
    matches the JAX XLA update on the port's own samples."""
    from pypmc_tpu_torch.ops import kernels

    rng = np.random.default_rng(7)
    jp, tp = mixture(rng, 30, 10, True)
    jt, tt = mixture(rng, 2, 10, False)
    kernels.reset_launch_counts()
    result, xT, w, _, _ = pmc.pmc_step_mixture_target(tp, tt, 3, 2000)
    counts = kernels.launch_counts()
    assert counts["plain:fused_is_pmc_step"] == 1 and counts["plain:fused_pmc_stats"] == 1
    assert counts["plain:fused_propose_logq"] == 0
    ref = jpmc.pmc_update(jp, jnp.asarray(xT.numpy()), jnp.asarray(w.numpy()),
                          transposed=True, fused="off")
    assert_params_close(result.params, ref.params, rtol=1e-8, atol=1e-10)
    with pytest.raises(ValueError, match=r"K\*D <= 128"):
        pmc.pmc_step_mixture_target(tp, tt, 3, 2000, fused="dense")


def test_blocked_election_raises_on_the_card(monkeypatch):
    """Where the JAX package elects its K-blocked kernel (K=400, N=2^22:
    the unfused (K, N) matrices would crowd 12 GiB), "auto" runs the
    K-blocked route, on the card and here alike: the decision depends on
    the shape alone.  At a small N the election is forced by lowering the
    12 GiB budget, as the JAX package's tests patch prefer_blocked; the
    update matches the JAX XLA update."""
    from pypmc_tpu_torch.ops import kernels

    assert kernels.elects_blocked("fused_pmc_stats", 400, 2, 1 << 22)
    assert not kernels.elects_blocked("fused_pmc_stats", 400, 2, 2000)
    rng = np.random.default_rng(9)
    jp, tp = mixture(rng, 400, 2, True)
    x = rng.normal(0, 2.5, (2, 2000))
    w = rng.exponential(1.0, 2000)
    monkeypatch.setattr(kernels, "_BLOCKED_HBM", 0)
    calls = []
    monkeypatch.setattr(kernels, "fused_pmc_stats_blocked",
                        lambda *a: calls.append(a) or kernels.plain_pmc_stats_blocked(*a))
    kernels.reset_launch_counts()
    got = pmc.pmc_update(tp, torch.tensor(x), torch.tensor(w), transposed=True)
    assert len(calls) == 1 and got.rho is None
    assert sum(kernels.launch_counts().values()) == 0      # no plain route
    ref = jpmc.pmc_update(jp, jnp.asarray(x), jnp.asarray(w), transposed=True, fused="off")
    assert_params_close(got.params, ref.params, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("K,D", [(2, 10), (2, 40), (2, 96), (2, 200), (400, 10)])
def test_mixture_logpdf_and_mahalanobis_on_both_sides_of_the_limit(K, D):
    """The JAX package runs fused_logq and fused_maha at K=2 for D=10, 40,
    96 and 200 (they fit its VMEM at a 128-particle tile; on the card D=96
    and D=200 take the block-tiled kernels) and takes XLA at K=400, D=10:
    the port runs the kernels' plain versions for the first four and its
    unfused tensor paths, counted as plain routes, for the last.  All match
    JAX."""
    from pypmc_tpu_torch.ops import kernels

    rng = np.random.default_rng(8)
    jp, tp = mixture(rng, K, D, True)
    xT = rng.normal(0, 2, (D, 400))
    unfused = K == 400
    assert kernels.fits("fused_logq", K, D) == kernels.fits("fused_maha", K, D) == (not unfused)
    kernels.reset_launch_counts()
    lq = core.mixture_logpdf_T(tp, torch.tensor(xT))
    maha = core.mahalanobis_all_T(tp, torch.tensor(xT))
    counts = kernels.launch_counts()
    assert counts["plain:fused_logq"] == counts["plain:fused_maha"] == int(unfused)
    np.testing.assert_allclose(lq.numpy(), np.asarray(jcore.mixture_logpdf_T(jp, jnp.asarray(xT))),
                               rtol=RTOL64, atol=ATOL64)
    np.testing.assert_allclose(maha.numpy(),
                               np.asarray(jcore.mahalanobis_all_T(jp, jnp.asarray(xT))),
                               rtol=RTOL64, atol=ATOL64)


class _Taken(Exception):
    """Raised where a JAX package's function takes a route: ``route`` is
    the kernel's route ("dense", "blocked") or None for its XLA path."""

    def __init__(self, route):
        super().__init__(route)
        self.route = route


# K*D <= 128 (the dense kernels), the K-blocked shapes (their VMEM fit;
# elected at 2^20 particles where the unfused (K, N) matrices would crowd
# 12 GiB: K > 1024), and shapes past both
ROUTE_SHAPES = [(10, 10), (3, 2), (16, 8), (128, 1), (30, 10), (400, 2), (2000, 2), (200, 10),
                (2, 200)]


@pytest.mark.parametrize("N", [1023, 1024, 1 << 20])
def test_statistics_routes_are_the_jax_routes(monkeypatch, N):
    """The port's route of fused_pmc_stats and fused_is_pmc_step (and of
    their K-blocked twins) is the one the JAX package's pmc_update
    (pmc.py:223) and pmc_step_mixture_target (:422) take at N particles:
    their own decision, read with the Pallas kernels and the XLA path
    replaced by stops and Pallas allowed on the CPU.  Below 1024 particles
    both take the unfused path."""
    monkeypatch.setenv("PYPMC_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("PYPMC_TPU_DISABLE_PALLAS", raising=False)
    monkeypatch.delenv("PYPMC_TPU_DISABLE_FUSED_RNG", raising=False)

    def stop(route):
        def taken(*args, **kwargs):
            raise _Taken(route)
        return taken

    for name in ("fused_pmc_stats", "fused_is_pmc_step"):
        monkeypatch.setattr(pk, name, stop("dense"))
        monkeypatch.setattr(pk, name + "_blocked", stop("blocked"))
    monkeypatch.setattr(jpmc, "calculate_rho_rb_T", stop(None))
    monkeypatch.setattr(jcore, "propose_logq_T", stop(None))
    rng = np.random.default_rng(11)
    Kt = 2
    jt = jcore.make_mixture(rng.normal(size=(Kt, 2)).astype(np.float32),
                            np.array([np.eye(2)] * Kt, dtype=np.float32))[0]
    seen = set()
    for K, D in ROUTE_SHAPES:
        jp = jcore.make_mixture(rng.normal(size=(K, D)).astype(np.float32),
                                np.array([np.eye(D)] * K, dtype=np.float32))[0]
        with pytest.raises(_Taken) as update:
            jpmc.pmc_update(jp, jnp.zeros((D, N), jnp.float32), transposed=True)
        assert kernels.route("fused_pmc_stats", K, D, N) == update.value.route, (K, D, N)
        if D == 2:
            jt_d = jt
        else:
            jt_d = jcore.make_mixture(rng.normal(size=(Kt, D)).astype(np.float32),
                                      np.array([np.eye(D)] * Kt, dtype=np.float32))[0]
        with pytest.raises(_Taken) as step:
            jpmc.pmc_step_mixture_target(jp, jt_d, jax.random.PRNGKey(0), N)
        assert kernels.route("fused_is_pmc_step", K, D, N, Kt) == step.value.route, (K, D, N)
        seen |= {update.value.route, step.value.route}
    assert seen == ({None} if N < 1024 else
                    {None, "dense", "blocked"} if N == 1 << 20 else {None, "dense"})


@pytest.mark.parametrize("student_t", [True, False])
def test_update_and_step_below_1024_particles_take_the_unfused_path(student_t):
    """At N=1000 the update and the step take the unfused path, each
    counted as its kernel's plain route, and match the JAX package's XLA
    update in float64 (the step on the port's own particles)."""
    rng = np.random.default_rng(12)
    jp, tp = mixture(rng, 3, 4, student_t)
    _, tt = mixture(rng, 2, 4, False)
    x = rng.normal(0, 2, (4, 1000))
    w = rng.exponential(1.0, 1000)
    kernels.reset_launch_counts()
    got = pmc.pmc_update(tp, torch.tensor(x), torch.tensor(w), transposed=True)
    counts = kernels.launch_counts()
    assert counts["plain:fused_pmc_stats"] == 1 and got.rho is not None
    ref = jpmc.pmc_update(jp, jnp.asarray(x), jnp.asarray(w), transposed=True, fused="off")
    assert_params_close(got.params, ref.params)

    kernels.reset_launch_counts()
    result, xT, w_step, _, sw = pmc.pmc_step_mixture_target(tp, tt, 5, 1000)
    counts = kernels.launch_counts()
    assert counts["plain:fused_is_pmc_step"] == 1 and counts["plain:fused_pmc_stats"] == 1
    assert result.rho is not None and xT.shape == (4, 1000)
    ref = jpmc.pmc_update(jp, jnp.asarray(xT.numpy()), jnp.asarray(w_step.numpy()),
                          transposed=True, fused="off")
    assert_params_close(result.params, ref.params, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(float(sw[0]), float(w_step.sum()), rtol=1e-12)
