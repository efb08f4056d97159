"""pypmc_tpu_torch.sampler, tools, the Gelman-Rubin grouping and
density._partition against the JAX package, and the plain versions of the
transform and chain-pool kernels against the Pallas kernels in interpret
mode.  Inputs are made with numpy and handed to both packages; the host
paths draw from the same ``numpy.random.RandomState`` seed, so they agree
to rounding."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pypmc_tpu.density as jd
import pypmc_tpu.density.core as jcore
import pypmc_tpu.ops.pallas_kernels as pk
import pypmc_tpu.sampler as js
import pypmc_tpu.tools as jtools
from pypmc_tpu.density._partition import patch_data as jax_patch_data
from pypmc_tpu.sampler.markov_chain import sample_adaptive_chains as jax_sample_adaptive_chains
import pypmc_tpu_torch
import pypmc_tpu_torch.density as td
import pypmc_tpu_torch.mix_adapt as tmix
import pypmc_tpu_torch.sampler as ts
import pypmc_tpu_torch.tools as ttools
from pypmc_tpu_torch.density import core
from pypmc_tpu_torch.ops import kernels

torch.set_num_threads(1)
# the package re-exports the function r_value under the module's name
jr = importlib.import_module("pypmc_tpu.mix_adapt.r_value")

RTOL64, ATOL64 = 1e-12, 1e-12


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port runs on the card unless the CPU is asked for: ask for it."""
    with pypmc_tpu_torch.using_device("cpu"):
        yield


@pytest.fixture()
def calls(monkeypatch):
    """The wrappers the dispatchers reached, by name: on the CPU a wrapper
    runs its plain version and counts no launch, so the routes are read
    here."""
    seen = []
    for name in ("fused_transform", "fused_transform_rng", "fused_logq", "fused_mcmc_pool",
                 "fused_propose_logq", "fused_draw_transform", "fused_draw_transform_rng"):
        def spy(*args, _name=name, _fn=getattr(kernels, name), **kwargs):
            seen.append(_name)
            return _fn(*args, **kwargs)
        monkeypatch.setattr(kernels, name, spy)
    return seen


@pytest.fixture()
def interpret(monkeypatch):
    monkeypatch.setattr(pk, "INTERPRET", True)
    monkeypatch.setattr(jcore, "use_pallas", lambda *a, **k: True)


MU = np.array([1.0, 2.0])
SIGMA = np.array([[1.0, 0.8], [0.8, 1.2]])
INV_SIGMA = np.linalg.inv(SIGMA)


def jax_log_target(x):
    diff = x - jnp.asarray(MU)
    return -0.5 * diff @ jnp.asarray(INV_SIGMA) @ diff


def torch_log_target(x):
    diff = x - torch.as_tensor(MU, dtype=x.dtype)
    return -0.5 * diff @ torch.as_tensor(INV_SIGMA, dtype=x.dtype) @ diff


def random_mixture(rng, K, D, student_t=False):
    means = rng.normal(0, 2, (K, D))
    a = rng.normal(0, 0.4, (K, D, D))
    covs = np.eye(D)[None] + np.einsum("kij,klj->kil", a, a)
    w = rng.uniform(0.5, 1.5, K)
    dofs = rng.uniform(4, 12, K) if student_t else None
    return means, covs, w / w.sum(), dofs


# ------------------------------------------------------------------ #
# the transform kernels' plain versions                               #
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("K,D,student_t", [(3, 5, True), (1, 1, False), (4, 7, False)])
def test_plain_transform_is_the_formula_and_matches_pallas(interpret, K, D, student_t):
    """plain_transform is ``mu[latent] + (L[latent] z) * scale`` to 1e-12 in
    float64, and agrees with pk.fused_transform in interpret mode on the
    same z, latent and scale to that kernel's split-precision product
    (three bfloat16 passes, ~2^-16 relative)."""
    rng = np.random.default_rng(K * 10 + D)
    means, covs, w, dofs = random_mixture(rng, K, D, student_t)
    jp, _ = jcore.make_mixture(means, covs, w, dofs)
    ops = core._kernel_operands(core.params_from_numpy(jp))
    N = 1500
    z = rng.normal(size=(D, N))
    lat = rng.integers(0, K, N).astype(np.int32)
    scale = rng.uniform(0.5, 2.0, N)
    got = kernels.plain_transform(torch.tensor(z), torch.tensor(lat), torch.tensor(scale),
                                  ops).numpy()
    chol = np.linalg.cholesky(covs)
    exact = means[lat].T + np.einsum("nij,jn->in", chol[lat], z) * scale
    np.testing.assert_allclose(got, exact, rtol=RTOL64, atol=ATOL64)
    ref = np.asarray(pk.fused_transform(jnp.asarray(z), jnp.asarray(lat), jnp.asarray(scale),
                                        jp.chol.reshape(K * D, D), jp.means.T, dim=D))
    np.testing.assert_allclose(got, ref, rtol=0, atol=2 ** -14 * np.abs(exact).max())
    # the wrapper on the CPU is the plain version
    np.testing.assert_array_equal(
        kernels.fused_transform(torch.tensor(z), torch.tensor(lat), torch.tensor(scale),
                                ops).numpy(), got)


@pytest.mark.parametrize("student_t", [False, True])
def test_plain_transform_rng_distribution(student_t):
    """The plain version of fused_transform_rng: each component's particles
    have its mean and covariance (Monte Carlo bounds), one seed gives one
    output and another seed another."""
    rng = np.random.default_rng(8)
    means, covs, w, dofs = random_mixture(rng, 3, 2, student_t)
    params, _ = core.make_mixture(means, covs, w, dofs)
    ops = core._kernel_operands(params)
    N = 60000
    lat = torch.tensor(rng.integers(0, 3, N).astype(np.int32))
    x = kernels.fused_transform_rng((4, 5), lat, ops).numpy()
    assert np.array_equal(x, kernels.fused_transform_rng((4, 5), lat, ops).numpy())
    assert not np.array_equal(x, kernels.fused_transform_rng((4, 6), lat, ops).numpy())
    for k in range(3):
        sel = x[:, lat.numpy() == k]
        cov = covs[k] * (dofs[k] / (dofs[k] - 2) if student_t else 1.0)
        se = np.sqrt(np.diag(cov) / sel.shape[1])
        assert np.all(np.abs(sel.mean(axis=1) - means[k]) < 5 * se)
        np.testing.assert_allclose(np.cov(sel), cov, atol=0.25 * np.abs(cov).max())


@pytest.mark.parametrize("K,D,n,route", [
    (11, 40, 1024, "fused_transform_rng"),
    (16, 40, 1024, "fused_transform"),
    (11, 40, 1000, "tensor"),
    (2, 3, 5000, "fused_transform_rng"),
])
def test_propose_T_routes_as_the_jax_package(calls, K, D, n, route):
    """propose_T takes the JAX package's routes (a refusal counted in
    launch_counts as ``plain:<kernel>``), each transform's up to D = 64 as
    one call that also draws (``fused_draw_transform_rng`` for
    ``fused_transform_rng``, ``fused_draw_transform`` for
    ``fused_transform``), and every route draws each component's particles
    around its mean."""
    rng = np.random.default_rng(K + D)
    means, covs, w, _ = random_mixture(rng, K, D)
    means *= 3.0
    params, _ = core.make_mixture(means, covs, w)
    kernels.reset_launch_counts()
    xT, lat = core.propose_T(params, 3, n)
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    want = {"tensor": {"plain:fused_transform_rng": 1, "plain:fused_transform": 1},
            "fused_transform": {"plain:fused_transform_rng": 1},
            "fused_transform_rng": {}}[route]
    assert counts == want
    assert calls == ([] if route == "tensor" else [route.replace("fused_", "fused_draw_")])
    assert tuple(xT.shape) == (D, n) and lat.dtype == torch.int32
    x, lat = xT.numpy(), lat.numpy()
    for k in np.unique(lat):
        sel = x[:, lat == k]
        if sel.shape[1] >= 30:
            bound = 6 * np.sqrt(np.diag(covs[k]) / sel.shape[1])
            assert np.all(np.abs(sel.mean(axis=1) - means[k]) < bound), (route, k)


def test_propose_logq_refusal_reaches_the_transform_kernel(calls):
    """Past fused_propose_logq's rule (K + Kt = 13 at D = 40) the draw is
    propose_T, which fits fused_transform_rng at K = 11; each log-density
    is then fused_logq."""
    rng = np.random.default_rng(3)
    params, _ = core.make_mixture(*random_mixture(rng, 11, 40)[:3])
    target, _ = core.make_mixture(*random_mixture(rng, 2, 40)[:3])
    kernels.reset_launch_counts()
    xT, lat, log_q, log_p = core.propose_logq_T(params, 1, 2048, target)
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    assert counts == {"plain:fused_propose_logq": 1}
    assert calls == ["fused_draw_transform_rng", "fused_logq", "fused_logq"]
    torch.testing.assert_close(log_q, core.mixture_logpdf_T(params, xT))


def test_mixture_propose_with_a_seed_reaches_the_kernels(calls):
    mix = td.create_t_mixture(np.zeros((2, 3)) + [[0.0], [5.0]], [np.eye(3)] * 2, [6.0, 9.0])
    x, lat = mix.propose(4096, rng=5, trace=True, shuffle=False)
    assert calls == ["fused_draw_transform_rng"]
    assert isinstance(x, np.ndarray) and x.shape == (4096, 3)
    assert abs(x[lat == 1].mean() - 5.0) < 0.1


# ------------------------------------------------------------------ #
# the chain pool's plain version                                      #
# ------------------------------------------------------------------ #

def bimodal_target(D=2):
    tm = np.zeros((2, D), np.float32)
    tm[1] += 4.0
    tc = np.array([np.eye(D) * 0.5] * 2, np.float32)
    return tm, tc, np.array([0.5, 0.5], np.float32)


def run_both_pools(C=200, steps=64, D=2, dof=None, nan_chain=None):
    """tests/test_rng_kernels.py's run_pool on the plain pool and on
    pk.fused_mcmc_pool in interpret mode, from the same inputs."""
    tm, tc, tw = bimodal_target(D)
    jp, _ = jcore.make_mixture(tm, tc, tw)
    tp = core.params_from_numpy(jp)
    rng = np.random.default_rng(3)
    starts = rng.normal(2, 1, (C, D)).astype(np.float32)
    chols = np.array([np.eye(D, dtype=np.float32) * 0.8] * C)
    if nan_chain is not None:
        chols[nan_chain] = np.nan
    cholr = chols.transpose(1, 2, 0).reshape(D * D, C)
    x0T = starts.T.copy()
    e0 = np.asarray(jcore.mixture_logpdf_T(jp, jnp.asarray(x0T)))
    ref = pk.fused_mcmc_pool(jnp.array([7, 9], jnp.int32), jnp.asarray(x0T), jnp.asarray(e0),
                             jnp.asarray(cholr), dof, jcore._pallas_operands(jp, "inv_chol"),
                             n_steps=steps, dim=D)
    got = kernels.fused_mcmc_pool((7, 9), torch.tensor(x0T), torch.tensor(e0),
                                  torch.tensor(cholr).double(), dof,
                                  core._kernel_operands(tp), steps)
    return [o.numpy() for o in got], [np.asarray(o) for o in ref], tp, starts


@pytest.mark.parametrize("C,dof", [(200, None), (130, 3.0)])
def test_plain_pool_invariants_as_the_pallas_pool(interpret, C, dof):
    """The invariants of tests/test_rng_kernels.py on both pools: the last
    point is the final state, ef is the log-density there, the NaN chain
    counts every step, accepts none and never moves; a float64 Cholesky
    runs in the chains' float32; one seed, one output."""
    nan_chain = 5
    got, ref, tp, starts = run_both_pools(C=C, steps=32, dof=dof, nan_chain=nan_chain)
    others = np.arange(C) != nan_chain
    for points, acc, nans, xf, ef in (got, ref):
        assert points.shape == (32, 2, C) and points.dtype == np.float32
        assert np.array_equal(points[-1], xf)
        ef_ref = core.mixture_logpdf_T(tp, torch.tensor(xf)).numpy()
        assert np.abs(ef - ef_ref)[others].max() < 1e-3
        assert nans[nan_chain] == 32 and acc[nan_chain] == 0
        assert np.array_equal(xf[:, nan_chain], starts[nan_chain])
        assert np.isfinite(points[:, :, others]).all() and (nans[others] == 0).all()
        assert (acc[others] > 0).all() and (acc < 32).all()
    # the two pools' acceptance agrees in distribution
    assert abs(got[1][others].mean() - ref[1][others].mean()) < 0.15 * 32
    again = run_both_pools(C=C, steps=32, dof=dof, nan_chain=nan_chain)[0]
    assert all(np.array_equal(a, b, equal_nan=True) for a, b in zip(got, again))


def whitened_step_moment(points, x0T, L):
    """Second moment of ``L_c^-1 (x_t - x_{t-1})`` over the steps that moved."""
    x = np.concatenate([x0T[None], points]).astype(np.float64)
    steps = np.transpose(x[1:] - x[:-1], (2, 1, 0))             # (C, D, n)
    w = np.transpose(np.linalg.solve(L.astype(np.float64), steps), (0, 2, 1))
    w = w[(steps != 0).any(axis=1)]
    return w.T @ w / len(w)


@pytest.mark.parametrize("dof", [None, 5.0])
def test_pool_full_cholesky_steps_as_the_pallas_pool(interpret, dof):
    """A full proposal factor a chain on a nearly flat target (every move
    is a proposal): both pools' whitened steps have second moment s I
    (s = dof / (dof - 2) for Student-t), which the plain pool run with the
    factors transposed misses by far."""
    C, D, steps = 256, 6, 48
    rng = np.random.default_rng(5)
    a = rng.normal(0, 1, (C, D, D))
    L = np.linalg.cholesky(np.eye(D)[None] + 4 * a @ a.transpose(0, 2, 1) / D).astype(np.float32)
    tm, tw = np.zeros((2, D), np.float32), np.array([0.35, 0.65], np.float32)
    tm[1] += 1.0
    jp, _ = jcore.make_mixture(tm, np.array([np.eye(D) * 1e6] * 2, np.float32), tw)
    tp = core.params_from_numpy(jp)
    x0T = rng.normal(0, 1, (D, C)).astype(np.float32)
    e0 = np.asarray(jcore.mixture_logpdf_T(jp, jnp.asarray(x0T)))
    as_cholr = lambda m: np.ascontiguousarray(m.transpose(1, 2, 0).reshape(D * D, C))
    ref = pk.fused_mcmc_pool(jnp.array([3, 4], jnp.int32), jnp.asarray(x0T), jnp.asarray(e0),
                             jnp.asarray(as_cholr(L)), dof,
                             jcore._pallas_operands(jp, "inv_chol"), n_steps=steps, dim=D)
    run = lambda m: kernels.fused_mcmc_pool((3, 4), torch.tensor(x0T), torch.tensor(e0),
                                            torch.tensor(as_cholr(m)), dof,
                                            core._kernel_operands(tp), steps)[0].numpy()
    s = 1.0 if dof is None else dof / (dof - 2.0)
    off = lambda points: np.abs(whitened_step_moment(points, x0T, L) - s * np.eye(D)).max() / s
    assert off(np.asarray(ref[0])) < 0.1
    assert off(run(L)) < 0.1
    assert off(run(L.transpose(0, 2, 1))) > 0.3


def test_pool_moments_match_the_pallas_pool(interpret, calls):
    """test_pool_moments_match_scan_pool's configuration through both
    packages' sample_adaptive_chains with a mixture target: the port's plain
    pool (its fused_mcmc_pool route on the CPU) against the JAX package's
    Pallas pool in interpret mode, pooled post-burn-in moments within 0.25
    and the mean acceptance within 0.1."""
    tm, tc, tw = bimodal_target(2)
    jp, _ = jcore.make_mixture(tm, tc, tw)
    tp = core.params_from_numpy(jp)
    rng = np.random.default_rng(0)
    starts = np.concatenate([rng.normal(0, 0.5, (64, 2)),
                             rng.normal(4, 0.5, (64, 2))]).astype(np.float32)
    sigma0 = np.eye(2, dtype=np.float32) * 0.5
    s_jax, r_jax = jax_sample_adaptive_chains(jp, starts, sigma0, 96, 3,
                                              key=jax.random.PRNGKey(0))
    s_port, r_port = ts.sample_adaptive_chains(tp, starts, sigma0, 96, 3, key=0)
    assert calls.count("fused_mcmc_pool") == 3
    a = np.asarray(s_jax)[:, 96:].reshape(-1, 2)
    b = s_port.numpy()[:, 96:].reshape(-1, 2)
    assert np.abs(a.mean(axis=0) - b.mean(axis=0)).max() < 0.25
    assert np.abs(a.std(axis=0) - b.std(axis=0)).max() < 0.25
    assert abs(np.asarray(r_jax).mean() - r_port.numpy().mean()) < 0.1


def test_pool_routes_and_nan_policy(calls):
    """float64 chains and a mixture target with an indicator take the
    tensor pool; a non-finite start raises; NaN proposals raise after the
    run unless continue_on_NaN."""
    tm, tc, tw = bimodal_target(2)
    tp, _ = core.make_mixture(tm.astype(float), tc.astype(float), tw.astype(float))
    starts = np.zeros((8, 2))
    s, r = ts.sample_adaptive_chains(tp, starts, np.eye(2), 16, 2, key=1)
    assert "fused_mcmc_pool" not in calls
    assert s.shape == (8, 32, 2) and r.shape == (8, 2)
    ind = ttools.indicator.hyperrectangle([-10.0, -10.0], [2.0, 10.0])
    s, _ = ts.sample_adaptive_chains(tp.to(torch.float32), starts, np.eye(2), 64, 2, key=2,
                                     indicator=ind)
    assert "fused_mcmc_pool" not in calls
    assert (s[..., 0] <= 2.0).all()
    with pytest.raises(ValueError, match="not finite"):
        ts.sample_adaptive_chains(tp, np.full((4, 2), np.nan), np.eye(2), 8, 1)

    def target(x):
        r2 = torch.sum(x * x)
        return torch.where(r2 < 4.0, -0.5 * r2, torch.full_like(r2, float("nan")))

    with pytest.raises(ValueError, match="NaN"):
        ts.sample_adaptive_chains(target, starts, np.eye(2) * 4.0, 32, 1, key=0)
    s, _ = ts.sample_adaptive_chains(target, starts, np.eye(2) * 4.0, 32, 1, key=0,
                                     continue_on_NaN=True)
    assert torch.isfinite(s).all()


def test_pool_adaptation_matches_the_jax_rule():
    """One batched adaptation step against the JAX package's adapt_step
    rule for every chain: the full Cholesky, the diagonal fallback for an
    indefinite estimate with a positive diagonal, the shrink-old fallback
    for a singular one."""
    from pypmc_tpu_torch.sampler.markov_chain import _adapt_pool

    p = {"covar_scale_multiplier": 1.5, "covar_scale_factor_max": 100.0,
         "covar_scale_factor_min": 0.0001, "force_acceptance_max": 0.35,
         "force_acceptance_min": 0.15, "damping": 0.5}
    rng = np.random.default_rng(4)
    C, n, D = 3, 50, 2
    points = rng.normal(size=(C, n, D))
    points[2] = 1.0                                   # a chain that never moved
    unscaled = np.array([np.eye(D), [[1.0, 6.0], [6.0, 1.0]], np.zeros((D, D))])
    scale = np.array([2.83, 1.0, 0.5])
    rates = np.array([0.5, 0.2, 0.0])
    chols = np.array([np.eye(D), np.eye(D) * 2, np.eye(D) * 3])
    cycle = 1
    new_u, new_s, new_c = (t.numpy() for t in _adapt_pool(
        *(torch.tensor(v) for v in (unscaled, scale, chols, points, rates)), cycle, p))
    for c in range(C):
        cov = np.cov(points[c], rowvar=False)
        a_t = 1.0 / (cycle + 1.0) ** 0.5
        u = (1 - a_t) * unscaled[c] + a_t * cov
        s = scale[c] * (1.5 if rates[c] > 0.35 and scale[c] < 100 else
                        1 / 1.5 if rates[c] < 0.15 and scale[c] > 1e-4 else 1.0)
        np.testing.assert_allclose(new_u[c], u, rtol=RTOL64, atol=ATOL64)
        np.testing.assert_allclose(new_s[c], s, rtol=RTOL64)
        try:
            want = np.linalg.cholesky(s * u)
        except np.linalg.LinAlgError:
            try:
                want = np.linalg.cholesky(np.diag(np.diag(s * u)))
                assert c == 1
            except np.linalg.LinAlgError:
                want = np.linalg.cholesky(chols[c] @ chols[c].T / 1.5)
                assert c == 2
        np.testing.assert_allclose(new_c[c], want, rtol=RTOL64, atol=ATOL64)


# ------------------------------------------------------------------ #
# MarkovChain / AdaptiveMarkovChain, host path                        #
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("student_t", [False, True])
def test_markov_chain_host_path_matches_jax(student_t):
    """The same RandomState seed gives identical samples, target values
    and accept counts."""
    if student_t:
        jprop, tprop = jd.LocalStudentT(np.eye(2) * 0.8, 5.0), td.LocalStudentT(np.eye(2) * 0.8, 5.0)
    else:
        jprop, tprop = jd.LocalGauss(np.eye(2) * 0.8), td.LocalGauss(np.eye(2) * 0.8)
    jmc = js.MarkovChain(jax_log_target, jprop, MU.copy(), save_target_values=True,
                         rng=np.random.RandomState(3))
    tmc = ts.MarkovChain(torch_log_target, tprop, MU.copy(), save_target_values=True,
                         rng=np.random.RandomState(3))
    for n in (300, 200):
        assert jmc.run(n) == tmc.run(n)
    np.testing.assert_allclose(tmc.samples[:], jmc.samples[:], rtol=RTOL64, atol=ATOL64)
    np.testing.assert_allclose(tmc.target_values[:], jmc.target_values[:], rtol=1e-10,
                               atol=1e-10)
    assert tmc.samples[:].shape == (500, 2) and len(tmc.samples) == 2


def test_adaptive_markov_chain_host_path_and_adapt_match_jax():
    """run/adapt cycles on the host path: identical samples, accept counts,
    sigma and scale factor after every adaptation, including the diagonal
    and the shrink-old fallbacks."""
    jmc = js.AdaptiveMarkovChain(jax_log_target, jd.LocalGauss(np.eye(2) * 20.0), MU.copy(),
                                 rng=np.random.RandomState(21))
    tmc = ts.AdaptiveMarkovChain(torch_log_target, td.LocalGauss(np.eye(2) * 20.0), MU.copy(),
                                 rng=np.random.RandomState(21))
    for _ in range(4):
        assert jmc.run(400) == tmc.run(400)
        jmc.adapt()
        tmc.adapt()
        np.testing.assert_allclose(tmc.samples[-1], jmc.samples[-1], rtol=RTOL64, atol=ATOL64)
        np.testing.assert_allclose(tmc.proposal.sigma, jmc.proposal.sigma, rtol=1e-10)
        np.testing.assert_allclose(tmc.unscaled_sigma, jmc.unscaled_sigma, rtol=1e-10)
        assert tmc.covar_scale_factor == pytest.approx(jmc.covar_scale_factor, rel=1e-14)
    for forged, want in (([[1.0, 6.0], [6.0, 1.0]], "diagonal"), (np.zeros((2, 2)), "shrink")):
        for mc in (jmc, tmc):
            mc.unscaled_sigma = np.array(forged)
            mc.damping = 0.0 if want == "shrink" else 0.5
            mc.samples.append(100)[:] = MU
            mc._last_accept_count = 0
        sigma_before = tmc.proposal.sigma.copy()
        jmc.adapt()
        tmc.adapt()
        np.testing.assert_allclose(tmc.proposal.sigma, jmc.proposal.sigma, rtol=1e-10)
        assert tmc.covar_scale_factor == pytest.approx(jmc.covar_scale_factor, rel=1e-14)
        if want == "diagonal":
            assert tmc.proposal.sigma[0, 1] == 0.0
        else:
            np.testing.assert_allclose(tmc.proposal.sigma, sigma_before / 1.5)


def test_markov_chain_device_path():
    """A LocalGauss chain without a numpy rng runs tensor steps on the
    device: the moments of the target, and the NaN policy."""
    mc = ts.AdaptiveMarkovChain(torch_log_target, td.LocalGauss(np.eye(2)), MU.copy(), rng=1)
    for _ in range(6):
        mc.run(2000)
        mc.adapt()
    pooled = mc.samples[:][4000:]
    np.testing.assert_allclose(pooled.mean(axis=0), MU, atol=0.2)
    np.testing.assert_allclose(np.cov(pooled, rowvar=False), SIGMA, atol=0.3)
    with pytest.raises(ValueError, match="finite"):
        ts.MarkovChain(torch_log_target, td.LocalGauss(np.eye(2)), [np.nan, 0.0])

    def nan_far(x):
        return torch.where(torch.sum(x * x) < 1.0, -torch.sum(x * x),
                           torch.tensor(float("nan"), dtype=x.dtype))

    mc = ts.MarkovChain(nan_far, td.LocalGauss(np.eye(2) * 4), [0.0, 0.0], rng=0)
    with pytest.raises(ValueError, match="NaN"):
        mc.run(50)
    assert len(mc.samples) == 0
    assert 0 <= mc.run(50, continue_on_NaN=True) < 50


# ------------------------------------------------------------------ #
# ImportanceSampler and the estimators                                #
# ------------------------------------------------------------------ #

def is_proposal(pkg):
    return pkg.create_gaussian_mixture([MU + 0.3, MU - 0.5], [np.eye(2) * 2.0, np.eye(2)],
                                       [0.6, 0.4])


def test_importance_sampler_host_path_matches_jax():
    """The same RandomState seed: identical samples, weights, target
    values and generating components."""
    jsm = js.ImportanceSampler(jax_log_target, is_proposal(jd), save_target_values=True,
                               rng=np.random.RandomState(11))
    tsm = ts.ImportanceSampler(torch_log_target, is_proposal(td), save_target_values=True,
                               rng=np.random.RandomState(11))
    jsm.run(700)
    tsm.run(700)
    np.testing.assert_array_equal(tsm.run(500, trace_sort=True), jsm.run(500, trace_sort=True))
    for field in ("samples", "weights", "target_values"):
        np.testing.assert_allclose(getattr(tsm, field)[:], getattr(jsm, field)[:],
                                   rtol=1e-10, atol=1e-14)
    assert len(tsm.samples) == 2


def test_importance_sampler_device_runs_and_combination():
    """run(to_host=False) keeps the run on the device, gather() flushes it,
    and combine_weights gives the same from the device tensors as from the
    host Histories; the evidence of a normalized target is 1."""
    target = td.create_gaussian_mixture([MU], [SIGMA]).evaluate_fn(batched=True)
    p1, p2 = is_proposal(td), td.create_gaussian_mixture([MU], [SIGMA * 1.5])
    s = ts.ImportanceSampler(target, p1, rng=7)
    s.run(4000, to_host=False)
    assert len(s.samples) == 0 and len(s.device_runs) == 1
    s.proposal = p2
    lat = s.run(3000, to_host=False, trace_sort=True)
    assert isinstance(lat, torch.Tensor) and lat.shape == (3000,)
    (sT1, w1), (sT2, w2) = s.device_runs
    dev = ts.combine_weights([sT1.T, sT2.T], [w1, w2], [p1, p2])[:][:, 0]
    assert s.gather() == 2 and s.samples[:].shape == (7000, 2)
    host = ts.combine_weights([s.samples[0], s.samples[1]],
                              [s.weights[0][:, 0], s.weights[1][:, 0]], [p1, p2])[:][:, 0]
    np.testing.assert_allclose(dev, host, rtol=1e-12)
    assert abs(dev.mean() - 1.0) < 0.05
    s.clear()
    assert len(s.samples) == 0 and s.device_runs == []


@pytest.mark.parametrize("path", ["log", "linear", "zeros"])
def test_combine_weights_matches_jax(path):
    """[Cor+12] weights on the same inputs: the log path, the linear path
    (a negative weight) and exact zeros (they stay on the log path and
    combine to exactly 0)."""
    rng = np.random.default_rng(0)
    samples = [rng.normal(0, 1, (50, 2)), rng.normal(1, 1.4, (80, 2))]
    weights = [np.abs(rng.normal(1, 0.1, 50)), np.abs(rng.normal(1, 0.1, 80))]
    if path == "linear":
        weights[0][4] = -0.5
    if path == "zeros":
        weights[0][[3, 17]] = 0.0
    mk = lambda pkg: [pkg.create_gaussian_mixture([np.zeros(2)], [np.eye(2)]),
                      pkg.create_t_mixture([np.ones(2)], [np.eye(2) * 2.0], [7.0])]
    ref = js.combine_weights(samples, weights, mk(jd))[:][:, 0]
    got = ts.combine_weights(samples, weights, mk(td))[:][:, 0]
    np.testing.assert_allclose(got, ref, rtol=RTOL64, atol=ATOL64)
    if path == "zeros":
        assert got[3] == 0.0 and got[17] == 0.0 and (got[got != 0] > 0).all()
    with pytest.raises(AssertionError):
        ts.combine_weights(samples, weights[:1], mk(td))


def test_estimators_match_jax():
    rng = np.random.default_rng(2)
    x, w = rng.normal(size=(40, 3)), rng.uniform(0.1, 2.0, 40)
    for name in ("calculate_mean", "calculate_covariance"):
        np.testing.assert_allclose(getattr(ts, name)(x, w).numpy(),
                                   np.asarray(getattr(js, name)(x, w)), rtol=RTOL64)
    np.testing.assert_allclose(
        ts.calculate_expectation(x, w, lambda v: v ** 2).numpy(),
        np.asarray(js.calculate_expectation(x, w, lambda v: v ** 2)), rtol=RTOL64)
    # a function that leaves torch takes the host loop, vector-valued too
    np.testing.assert_allclose(
        ts.calculate_expectation(x, w, lambda v: np.square(v.numpy())).numpy(),
        np.asarray(js.calculate_expectation(x, w, lambda v: v ** 2)), rtol=RTOL64)


@pytest.mark.parametrize("name,fn", [
    ("item", lambda v: -0.5 * float(v @ v)),
    ("numpy", lambda v: -0.5 * np.sum(v.numpy() ** 2)),
    ("control flow", lambda v: -0.5 * v @ v if v[0] > -1e9 else v[0]),
])
def test_unmappable_target_takes_the_host_loop_and_says_so(caplog, name, fn):
    """A per-point target that torch.func.vmap cannot map is evaluated point
    by point, with a warning; a target that is simply wrong raises."""
    from pypmc_tpu_torch.sampler._target import evaluate_target

    x = torch.tensor(np.random.default_rng(3).normal(size=(7, 3)))
    with caplog.at_level("WARNING", logger="pypmc_tpu_torch.sampler._target"):
        got = evaluate_target(fn, x)
    assert "one at a time" in caplog.text
    np.testing.assert_allclose(got.numpy(), -0.5 * np.sum(x.numpy() ** 2, axis=1),
                               rtol=RTOL64)
    with pytest.raises(RuntimeError, match="size mismatch"):
        evaluate_target(lambda v: v @ torch.ones(4, dtype=v.dtype), x)


def test_plain_streams_depend_on_both_seed_words():
    """A CPU generator keeps 32 bits of its seed: both seed words of a
    plain version's generator still move its stream."""
    from pypmc_tpu_torch._rng import device_generator

    draw = lambda seed: torch.rand(4, generator=device_generator(seed, "cpu"))
    assert not torch.equal(draw((1, 7)), draw((2, 7)))
    assert not torch.equal(draw((1, 7)), draw((1, 8)))
    assert torch.equal(draw((1, 7)), draw((1, 7)))


# ------------------------------------------------------------------ #
# tools, the Gelman-Rubin grouping and the patches                    #
# ------------------------------------------------------------------ #

def test_tools_match_jax():
    rng = np.random.default_rng(1)
    w = rng.exponential(1.0, 1000)
    w[:5] = 0.0
    for name in ("perp", "ess"):
        assert float(getattr(ttools, name)(w)) == pytest.approx(
            float(getattr(jtools, name)(w)), rel=1e-12)
        huge = w * 1e300          # the max-ratio form: no overflow
        assert float(getattr(ttools, name)(huge)) == pytest.approx(
            float(getattr(ttools, name)(w)), rel=1e-12)
    h = ttools.History(3)
    assert h[:].shape == (0, 3)
    h.append(2)[:] = 1.0
    h.append(3)[:] = 2.0
    assert h[:].shape == (5, 3) and h[-1].shape == (3, 3) and len(h) == 2
    ball = ttools.indicator.ball([0.0, 0.0], 1.0)
    assert bool(ball(torch.tensor([0.5, 0.5]))) and not bool(ball(torch.tensor([1.0, 1.0])))
    with pytest.raises(ValueError, match="dimension"):
        ball(torch.zeros(3))
    with pytest.raises(ValueError):
        ttools.indicator.hyperrectangle([0.0, 1.0], [1.0, 1.0])
    assert ttools.partition(7, 3) == [3, 2, 2]


def chains(seed=5, n=600):
    rng = np.random.default_rng(seed)
    return ([rng.normal(0, 1, size=(n, 3)) for _ in range(3)]
            + [rng.normal(8, 1, size=(n, 3)) for _ in range(2)]
            + [rng.normal(0.3, 1.2, size=(n, 3))])


def test_r_value_and_r_group_match_jax():
    rng = np.random.default_rng(9)
    for approx in (False, True):
        for m in (2, 3, 7):
            means, variances = rng.normal(0, 1, m), rng.uniform(0.5, 2, m)
            assert tmix.r_value(means, variances, 500, approx) == pytest.approx(
                jr.r_value(means, variances, 500, approx), rel=RTOL64)
    cs = chains()
    means = np.array([c.mean(axis=0) for c in cs])
    variances = np.array([c.var(axis=0, ddof=1) for c in cs])
    for critical_r in (1.1, 2.0, 5.0):
        assert tmix.r_group(means, variances, 600, critical_r) == \
            jr.r_group(means, variances, 600, critical_r)


@pytest.mark.parametrize("K_g,indices", [(1, None), (4, None), (2, [0, 2]), (9, None)])
def test_make_r_mixtures_match_jax(K_g, indices):
    for make in ("make_r_gaussmix", "make_r_tmix"):
        got = getattr(tmix, make)(chains(), K_g=K_g, indices=indices)
        ref = getattr(jr, make)(chains(), K_g=K_g, indices=indices)
        assert len(got) == len(ref)
        np.testing.assert_allclose(got.weights, ref.weights, rtol=RTOL64)
        for a, b in zip(got.components, ref.components):
            np.testing.assert_allclose(a.mu, b.mu, rtol=RTOL64, atol=ATOL64)
            np.testing.assert_allclose(a.sigma, b.sigma, rtol=RTOL64, atol=ATOL64)


def test_patch_data_matches_jax():
    """Patches of one row are dropped; a constant patch falls back and is
    dropped; the rest carry their empirical moments."""
    rng = np.random.default_rng(2)
    data = np.vstack([rng.normal(size=(230, 2)), np.zeros((100, 2)), rng.normal(size=(101, 2))])
    for L in (100, 50):
        got, ref = td.patch_data(data, L=L), jax_patch_data(data, L=L)
        assert len(got) == len(ref)
        for a, b in zip(got.components, ref.components):
            np.testing.assert_allclose(a.mu, b.mu, rtol=RTOL64, atol=ATOL64)
            np.testing.assert_allclose(a.sigma, b.sigma, rtol=RTOL64, atol=ATOL64)
