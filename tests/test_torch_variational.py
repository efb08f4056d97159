"""pypmc_tpu_torch.mix_adapt.variational against pypmc_tpu.mix_adapt.variational
in float64: both packages start from one numpy-seeded state and are held to
each other on the JAX XLA path.  On the CPU the port's one-pass E-step runs
the plain version of fused_vb_estep and un-whitens with triangular solves,
and its (N, K) fields and VBMerge's E-step run the plain version of
fused_maha; the JAX package runs its unfused XLA E-step.

Tolerances: the two packages do the same float64 arithmetic in other
orders (whitened statistics against direct sums), so values agree to
RTOL64/ATOL64 below; a bound agrees to RTOL64 relative.  VBMerge's logits
are scaled by N omega_l / 2 (25 here), which scales the rounding of its
responsibilities: RTOL_MERGE.  A run stops where the bound's relative
change falls below 1e-10, so rounding can move the stop by an iteration:
the iteration counts agree within 1 and the end states to RTOL_RUN."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import digamma, gammaln

from pypmc_tpu.density import create_gaussian_mixture as jax_create_gaussian_mixture
from pypmc_tpu.mix_adapt import variational as jvb
import pypmc_tpu_torch
from pypmc_tpu_torch.density import create_gaussian_mixture
from pypmc_tpu_torch.mix_adapt import variational as tvb
from pypmc_tpu_torch.ops import kernels

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port runs on the card unless the CPU is asked for: ask for it."""
    with pypmc_tpu_torch.using_device("cpu"):
        yield

RTOL64, ATOL64 = 1e-9, 1e-11
RTOL_MERGE = 1e-7
RTOL_RUN = 1e-6

RNG = np.random.default_rng(7251)
DATA = np.vstack([RNG.normal([0.0, 0.0], 0.5, size=(30, 2)),
                  RNG.normal([4.0, 4.0], 0.7, size=(20, 2))])
WEIGHTS = np.abs(RNG.normal(1.0, 0.4, size=len(DATA)))
K = 3
PRIOR = dict(alpha0=np.array([1.0, 1.5, 2.0]), beta0=np.array([1.0, 1.0, 2.0]),
             nu0=np.array([3.0, 4.0, 5.0]), m0=np.array([[0.0, 0.0], [1.0, 1.0], [-1.0, 2.0]]),
             W0=np.array([np.eye(2), np.eye(2) * 2.0, np.eye(2) * 0.5]))
E_FIELDS = ("expectation_det_ln_lambda", "expectation_ln_pi", "expectation_gauss_exponent",
            "r", "log_rho", "N_comp", "x_mean_comp", "S")
HYPER = ("alpha", "beta", "nu", "m", "W", "log_det_W")


def both(weights=None, **kw):
    """The JAX object and the port's, from one state."""
    args = dict(PRIOR, components=K) if not kw else kw
    return (jvb.GaussianInference(DATA, weights=weights, **args),
            tvb.GaussianInference(DATA, weights=weights, **args))


def close(got, ref, rtol=RTOL64, atol=ATOL64, what=""):
    np.testing.assert_allclose(tvb._host(got), np.asarray(ref), rtol=rtol, atol=atol,
                               err_msg=what)


def assert_same_state(t, j, fields=E_FIELDS + HYPER, rtol=RTOL64):
    for f in fields:
        close(getattr(t, f), getattr(j, f), rtol=rtol, what=f)


def assert_runs_agree(t_iterations, j_iterations):
    assert t_iterations is not None and j_iterations is not None
    assert abs(t_iterations - j_iterations) <= 1


# ------------------------------------------------------------------ #
# exact steps                                                         #
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("weighted", [False, True])
def test_first_e_step(weighted, monkeypatch):
    """Both E-steps of the constructor: the one-pass (plain fused_vb_estep)
    statistics and the (N, K) fields formed on demand.  The one-pass
    E-step runs from 1024 points, as the JAX package's: the rule is
    lowered here so that the 50 points take it."""
    monkeypatch.setattr(kernels, "_MIN_N", 1)
    j, t = both(WEIGHTS if weighted else None)
    assert t._e.r is None            # the one-pass E-step ran
    assert_same_state(t, j)
    close(t.likelihood_bound(), j.likelihood_bound(), what="bound")


def test_first_update():
    j, t = both()
    j.update()
    t.update()
    assert_same_state(t, j)


def test_update_with_bound_matches_update_then_bound():
    j, t = both(WEIGHTS)
    for _ in range(3):
        close(t._update_with_bound(), j._update_with_bound(), what="bound")
    assert_same_state(t, j, ("N_comp", "x_mean_comp", "S") + HYPER)


def test_set_variational_parameters_from_jax_state():
    """The dict of the JAX object's prior_posterior() starts the port from
    the JAX object's state, mid-run."""
    j, _ = both()
    for _ in range(4):
        j.update()
    t = tvb.GaussianInference(DATA, components=K)
    t.set_variational_parameters(**j.prior_posterior())
    t.E_step()
    j.E_step()
    assert_same_state(t, j)
    with pytest.raises(ValueError, match="components"):
        t.set_variational_parameters(**dict(j.prior_posterior(), components=K + 1))


# ------------------------------------------------------------------ #
# Wishart / Dirichlet                                                  #
# ------------------------------------------------------------------ #

def test_wishart_log_B():
    nu, w = 4.0, 2.0
    expected = -0.5 * nu * np.log(w) - 0.5 * nu * np.log(2) - gammaln(0.5 * nu)
    assert np.isclose(tvb.Wishart_log_B(1, nu, np.log(w)), expected)
    nus, log_dets = np.array([3.5, 7.0]), np.array([-0.3, 1.2])
    close(tvb._wishart_log_B(3, torch.tensor(nus), torch.tensor(log_dets)),
          jvb._wishart_log_B(3, jnp.asarray(nus), jnp.asarray(log_dets)))


def test_wishart_expect_log_lambda():
    nu, w = 6.0, 0.5
    expected = digamma(0.5 * nu) + np.log(2) + np.log(w)
    assert np.isclose(tvb.Wishart_expect_log_lambda(1, nu, np.log(w)), expected)
    nus, log_dets = np.array([3.5, 7.0]), np.array([-0.3, 1.2])
    close(tvb._wishart_expect_log_lambda(3, torch.tensor(nus), torch.tensor(log_dets)),
          jvb._wishart_expect_log_lambda(3, jnp.asarray(nus), jnp.asarray(log_dets)))


def test_dirichlet_log_C():
    alpha = np.array([1.0, 2.0, 3.5])
    expected = gammaln(alpha.sum()) - gammaln(alpha).sum()
    assert np.isclose(tvb.Dirichlet_log_C(alpha), expected)
    close(tvb._dirichlet_log_C(torch.tensor(alpha)), jvb._dirichlet_log_C(jnp.asarray(alpha)))


def test_wishart_H():
    assert np.isfinite(tvb.Wishart_H(2, 5.0, 0.3))
    assert tvb.Wishart_H(2, 5.0, 0.3) == jvb.Wishart_H(2, 5.0, 0.3)
    nus, log_dets = np.array([3.5, 7.0]), np.array([-0.3, 1.2])
    close(tvb._wishart_H(3, torch.tensor(nus), torch.tensor(log_dets)),
          jvb._wishart_H(3, jnp.asarray(nus), jnp.asarray(log_dets)))


# ------------------------------------------------------------------ #
# convergence                                                         #
# ------------------------------------------------------------------ #

def test_bound_increases_monotonically():
    j, t = both()
    bounds = [t.likelihood_bound()]
    ref = [j.likelihood_bound()]
    for _ in range(20):
        t.update()
        j.update()
        bounds.append(t.likelihood_bound())
        ref.append(j.likelihood_bound())
    np.testing.assert_allclose(bounds, ref, rtol=RTOL64)
    assert np.all(np.diff(bounds) > -1e-8), bounds


def test_run_converges():
    j, t = both()
    assert_runs_agree(t.run(iterations=500, prune=0.0), j.run(iterations=500, prune=0.0))
    close(t.likelihood_bound(), j.likelihood_bound(), rtol=RTOL_RUN, what="bound")


def test_run_terminates_under_bound_oscillation(monkeypatch):
    """``run`` neither hangs nor converges on a decrease step when the bound
    oscillates at ulp scale (as float32 statistics can make it)."""
    _, t = both()
    calls = {"n": 0}

    def oscillating(*_a, **_k):
        calls["n"] += 1
        return -100.0 + (1e-4 if calls["n"] % 2 == 0 else -1e-4)

    monkeypatch.setattr(t, "likelihood_bound", oscillating)
    monkeypatch.setattr(t, "_update_with_bound", oscillating)
    monkeypatch.setattr(t, "prune", lambda *_a, **_k: None)
    assert t.run(iterations=30, prune=0.0, rel_tol=1e-12, abs_tol=1e-15) is None
    calls["n"] = 0
    assert t.run(iterations=30, prune=0.0, rel_tol=1e-3) is not None
    assert calls["n"] % 2 == 0  # converged on an increase step


def test_run_with_prune_finds_two_clusters():
    kw = dict(components=6, alpha0=1e-5, beta0=1e-5)
    j, t = both(**kw)
    assert_runs_agree(t.run(iterations=1000, prune=1.0), j.run(iterations=1000, prune=1.0))
    mix, ref = t.make_mixture(), j.make_mixture()
    assert len(mix) == len(ref) == 2
    means = sorted(c.mu[0] for c in mix.components)
    np.testing.assert_allclose(means, sorted(c.mu[0] for c in ref.components), rtol=RTOL_RUN)
    assert np.isclose(means[0], 0.0, atol=0.3) and np.isclose(means[1], 4.0, atol=0.3)
    close(mix.weights, ref.weights, rtol=RTOL_RUN)


def test_prune_reindexes():
    j, t = both(components=6, alpha0=1e-5, beta0=1e-5)
    j.update()
    t.update()
    j.prune(threshold=1.0)
    t.prune(threshold=1.0)
    assert t.K == j.K <= 6
    assert len(t.alpha) == t.K and t.r.shape == (len(DATA), t.K)
    assert_same_state(t, j)


def test_posterior2prior_roundtrip():
    j, t = both()
    t.run(iterations=50)
    j.run(iterations=50)
    seq = tvb.GaussianInference(DATA, **t.posterior2prior())
    assert seq.K == t.K
    close(seq.alpha0, t.alpha)
    jseq = jvb.GaussianInference(DATA, **j.posterior2prior())
    assert_same_state(seq, jseq, rtol=RTOL_RUN)


def test_initial_guess_mixture():
    args = ([np.array([0.0, 0.0]), np.array([4.0, 4.0])], [np.eye(2) * 0.5, np.eye(2) * 0.5])
    t = tvb.GaussianInference(DATA, initial_guess=create_gaussian_mixture(*args))
    j = jvb.GaussianInference(DATA, initial_guess=jax_create_gaussian_mixture(*args))
    assert t.K == 2
    assert_same_state(t, j)
    assert_runs_agree(t.run(iterations=200), j.run(iterations=200))
    assert_same_state(t, j, ("N_comp", "x_mean_comp", "S") + HYPER, rtol=RTOL_RUN)
    means = sorted(c.mu[0] for c in t.make_mixture().components)
    assert np.isclose(means[0], 0.0, atol=0.3) and np.isclose(means[1], 4.0, atol=0.3)


def test_initial_guess_conflicts_raise():
    guess = create_gaussian_mixture([np.zeros(2)], [np.eye(2)])
    with pytest.raises(ValueError):
        tvb.GaussianInference(DATA, initial_guess=guess, m=np.zeros((1, 2)))


def test_argument_validation():
    with pytest.raises(ValueError):
        tvb.GaussianInference(DATA)  # no components, no initial guess
    with pytest.raises(ValueError):
        tvb.GaussianInference(DATA, components=3, alpha0=-1.0)
    with pytest.raises(TypeError):
        tvb.GaussianInference(DATA, components=3, bogus_parameter=1.0)
    with pytest.raises(ValueError, match="weights"):
        tvb.GaussianInference(DATA, components=3, weights=np.ones(3))
    with pytest.raises(TypeError, match="particle mesh"):
        tvb.GaussianInference(DATA, components=3, mesh=object())


# ------------------------------------------------------------------ #
# the size gate                                                       #
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("K,D", [(2, 40), (15, 10)])
def test_e_step_past_the_kernel_limit_takes_the_unfused_path(K, D):
    """The JAX package runs its one-pass E-step for K*D <= 128 (K=2, D=40
    included) and its XLA E-step past it (K=15, D=10).  The port routes
    alike: the one-pass E-step at K=2, D=40, and the unfused tensor code,
    counted as plain:fused_vb_estep, at K=15, D=10.  Both match.  (1100
    points: the one-pass E-step runs from 1024.)"""
    rng = np.random.default_rng(5)
    centers = rng.normal(0, 6, (K, D))
    data = centers[np.arange(1100) % K] + rng.normal(0, 1, (1100, D))
    one_pass = K * D <= 128
    assert kernels.fits("fused_vb_estep", K, D) == one_pass
    kernels.reset_launch_counts()
    t = tvb.GaussianInference(data, components=K)
    j = jvb.GaussianInference(data, components=K)
    counts = kernels.launch_counts()
    assert counts["plain:fused_vb_estep"] == int(not one_pass)
    assert counts["plain:fused_maha"] == 0
    assert (t._e.r is None) == one_pass
    assert_same_state(t, j)


# ------------------------------------------------------------------ #
# VBMerge                                                             #
# ------------------------------------------------------------------ #

def merge_input(create):
    rng = np.random.default_rng(3)
    means = np.vstack([rng.normal([0, 0], 0.3, size=(10, 2)),
                       rng.normal([5, 5], 0.3, size=(10, 2))])
    return create(means, np.array([np.eye(2) * 0.5] * 20))


def test_vbmerge_compresses_to_two():
    kw = dict(N=1000, components=6, alpha0=1e-5, beta0=1e-5)
    t = tvb.VBMerge(merge_input(create_gaussian_mixture), **kw)
    j = jvb.VBMerge(merge_input(jax_create_gaussian_mixture), **kw)
    assert_same_state(t, j, ("N_comp", "x_mean_comp", "S", "r", "expectation_gauss_exponent"),
                      rtol=RTOL_MERGE)
    assert_runs_agree(t.run(iterations=500, prune=1.0), j.run(iterations=500, prune=1.0))
    out = t.make_mixture()
    assert len(out) == 2
    means = sorted(c.mu[0] for c in out.components)
    assert np.isclose(means[0], 0.0, atol=0.4) and np.isclose(means[1], 5.0, atol=0.4)
    close(out.weights, j.make_mixture().weights, rtol=RTOL_RUN)
    assert np.allclose(sorted(out.weights), [0.5, 0.5], atol=0.1)


def test_vbmerge_bound_increases():
    t = tvb.VBMerge(merge_input(create_gaussian_mixture), N=100, components=4)
    j = jvb.VBMerge(merge_input(jax_create_gaussian_mixture), N=100, components=4)
    bounds, ref = [t.likelihood_bound()], [j.likelihood_bound()]
    for _ in range(10):
        t.update()
        j.update()
        bounds.append(t.likelihood_bound())
        ref.append(j.likelihood_bound())
    np.testing.assert_allclose(bounds, ref, rtol=RTOL_MERGE)
    assert np.all(np.diff(bounds) > -1e-8)


def test_vbmerge_initial_guess_first_uses_input_means():
    t = tvb.VBMerge(merge_input(create_gaussian_mixture), N=100, components=3,
                    initial_guess="first")
    assert np.allclose(tvb._host(t.m), tvb._host(t.mu[:3]))
