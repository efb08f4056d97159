"""The ported PMC main path as a whole against pypmc_tpu: one step's update
on identical samples in float64, and the whole pmc_run_sharded run loop in
both packages held to the normalized target's evidence of 1."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pypmc_tpu.density.core as jcore
import pypmc_tpu.mix_adapt.pmc as jpmc
from pypmc_tpu.parallel import pmc_run_sharded as jax_pmc_run_sharded
import pypmc_tpu_torch
from pypmc_tpu_torch.density import core
from pypmc_tpu_torch.mix_adapt.pmc import pmc_step_mixture_target
from pypmc_tpu_torch.parallel import pmc_run_sharded, run_is_step_sharded

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port runs on the card unless the CPU is asked for: ask for it."""
    with pypmc_tpu_torch.using_device("cpu"):
        yield

K, D = 3, 4


def problem(student_t=True):
    """A bimodal Gaussian-mixture target (weights 0.3/0.7) and a wide
    proposal, as examples/pmc_large_scale.py builds them."""
    rng = np.random.default_rng(0)
    t_means = np.stack([rng.normal(0, 1, D), rng.normal(0, 1, D) + 3.0])
    t_covs = np.array([np.eye(D) * 0.8, np.eye(D) * 1.2])
    jt, _ = jcore.make_mixture(t_means, t_covs, np.array([0.3, 0.7]))
    means = rng.normal(1.5, 3.0, size=(K, D))
    covs = np.array([np.eye(D) * 6.0] * K)
    jp, _ = jcore.make_mixture(means, covs, None,
                               np.full((K,), 8.0) if student_t else None)
    return jp, jt, core.params_from_numpy(jp), core.params_from_numpy(jt)


@pytest.mark.parametrize("student_t", [True, False])
def test_step_update_matches_jax_on_the_ports_samples(student_t):
    jp, jt, tp, tt = problem(student_t)
    result, xT, w, latent, sw = pmc_step_mixture_target(tp, tt, 3, 1 << 13)
    ref = jpmc.pmc_update(jp, jnp.asarray(xT.numpy()), jnp.asarray(w.numpy()),
                          rb=True, transposed=True, fused="off",
                          dof_solver_steps=100 if student_t else 0)
    for f, v in core.params_to_numpy(result.params).items():
        r = getattr(ref.params, f)
        if v is None:
            assert r is None
            continue
        np.testing.assert_allclose(v, np.asarray(r), rtol=1e-10, atol=1e-12, err_msg=f)
    np.testing.assert_allclose(float(sw[0]), float(w.sum()), rtol=1e-12)


def evidence_within(stats, n, sigmas=5.0):
    """Each step's evidence within ``sigmas`` Monte Carlo standard errors
    of 1 (the target is normalized); the error follows from the ESS."""
    ev = np.asarray(stats.evidence, dtype=np.float64)
    ess = np.asarray(stats.ess, dtype=np.float64)
    sigma = ev * np.sqrt((1.0 / ess - 1.0) / n)
    assert np.all(np.isfinite(ev)) and np.all(np.abs(ev - 1.0) < sigmas * sigma), (ev, sigma)


@pytest.mark.single_process(reason="materializes the sharded JAX run's statistics")
def test_pmc_run_sharded_both_packages():
    jp, jt, tp, tt = problem()
    n, steps = 1 << 14, 5
    _, jstats = jax_pmc_run_sharded(jt, jp, n, steps, key=jax.random.PRNGKey(1))
    out, stats = pmc_run_sharded(tt, tp, n, steps, key=1)
    evidence_within(jstats, n)
    evidence_within(stats, n)
    assert stats.ess.shape == (steps,) and float(stats.ess[-1]) > 0.5
    assert float(np.asarray(jstats.ess)[-1]) > 0.5
    assert torch.isfinite(stats.log_likelihood).all()
    assert torch.isfinite(out.means).all() and out.dof.shape == (K,)


def test_pmc_run_sharded_branches():
    """The weight-clip and callable-target branch, scan_steps, and
    return_final_samples."""
    _, _, tp, tt = problem()
    n = 1 << 12
    a = pmc_run_sharded(tt, tp, n, 3, key=5)
    b = pmc_run_sharded(tt, tp, n, 3, key=5, scan_steps=True)
    for f in ("means", "cov", "weights", "dof"):
        assert torch.equal(getattr(a[0], f), getattr(b[0], f))
    for x, y in zip(a[1], b[1]):
        assert torch.equal(x, y)

    def log_target(xT):
        return core.mixture_logpdf_T(tt, xT)
    log_target.__pypmc_tpu_transposed__ = True
    clipped, cstats, samples, w = pmc_run_sharded(
        log_target, tp, n, 3, key=6, weight_clip=True, return_final_samples=True)
    assert samples.shape == (D, n) and w.shape == (n,)
    assert torch.isfinite(cstats.evidence).all()
    evidence_within(cstats, n)
    _, nstats = pmc_run_sharded(tt, tp, n, 2, key=7, rb=False,
                                compute_log_likelihood=False)
    assert torch.isnan(nstats.log_likelihood).all()
    with pytest.raises(ValueError):
        pmc_run_sharded(tt, tp, n, 1, scan_steps=True, return_final_samples=True)


def test_run_is_step_sharded_row_major_callable():
    _, _, tp, tt = problem()
    xT, w, latent = run_is_step_sharded(
        tp, lambda x: core.mixture_logpdf(tt, x), 2, 999)
    assert xT.shape == (D, 999) and w.shape == (999,) and latent.shape == (999,)
    np.testing.assert_allclose(
        w.numpy(),
        torch.exp(core.mixture_logpdf_T(tt, xT) - core.mixture_logpdf_T(tp, xT)).numpy(),
        rtol=1e-12)


def test_multi_rank_group_is_refused(monkeypatch):
    _, _, tp, tt = problem()
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    with pytest.raises(NotImplementedError):
        pmc_run_sharded(tt, tp, 64, 1)
