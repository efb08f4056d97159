"""The ported PMC main path as a whole against pypmc_tpu: one step's update
on identical samples in float64, and the whole pmc_run_sharded run loop in
both packages held to the normalized target's evidence of 1.  Its
``scan_steps=True`` path (the steps through ``sampler._scan.Scan``, their
seed words from a table on the device) against the loop, bit for bit."""

import logging

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
from pypmc_tpu_torch.ops import kernels
from pypmc_tpu_torch.parallel import pmc_run_sharded, run_is_step_sharded
from pypmc_tpu_torch.parallel import sampler as psampler
from pypmc_tpu_torch.sampler import _scan, batched_target

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

    @batched_target(transposed=True)
    def log_target(xT):
        return core.mixture_logpdf_T(tt, xT)
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
        tp, batched_target(lambda x: core.mixture_logpdf(tt, x)), 2, 999)
    assert xT.shape == (D, 999) and w.shape == (999,) and latent.shape == (999,)
    np.testing.assert_allclose(
        w.numpy(),
        torch.exp(core.mixture_logpdf_T(tt, xT) - core.mixture_logpdf_T(tp, xT)).numpy(),
        rtol=1e-12)


# a per-point target that indexes coordinates: a 0.3/0.7 mixture of two
# axis-aligned Gaussians in D=2, written once for torch and once for jax.numpy
PP_MU = np.array([[5.0, 0.01], [-4.0, 1.0]])
PP_VAR = np.array([[0.5, 0.2], [1.0, 0.3]])
PP_W = np.array([0.3, 0.7])


def per_point_target(xp):
    def log_target(x):
        lp = [np.log(PP_W[k]) - 0.5 * np.log(4 * np.pi ** 2 * PP_VAR[k].prod())
              - 0.5 * ((x[0] - PP_MU[k, 0]) ** 2 / PP_VAR[k, 0]
                       + (x[1] - PP_MU[k, 1]) ** 2 / PP_VAR[k, 1]) for k in range(2)]
        return xp.logaddexp(lp[0], lp[1])
    return log_target


def per_point_proposal():
    rng = np.random.default_rng(3)
    means = rng.normal(0.0, 3.0, (3, 2))
    return core.make_mixture(means, np.array([np.eye(2) * 4.0] * 3), None, np.full(3, 8.0))[0]


@pytest.mark.parametrize("entry", ["run_is_step_sharded", "pmc_run_sharded"])
def test_per_point_callable_target_is_mapped_over_the_particles(entry):
    """An unmarked callable is a per-point target, as in the JAX package:
    the weights on the port's own samples are exp(log p - log q) with log p
    from the JAX package's evaluate_target_T (a jax.vmap)."""
    from pypmc_tpu.sampler._target import evaluate_target_T as jax_evaluate_target_T

    p0 = per_point_proposal()
    if entry == "run_is_step_sharded":
        xT, w, _ = run_is_step_sharded(p0, per_point_target(torch), 2, 999)
    else:
        _, _, xT, w = pmc_run_sharded(per_point_target(torch), p0, 999, 1, key=2,
                                      return_final_samples=True)
    log_p = np.asarray(jax_evaluate_target_T(per_point_target(jnp), jnp.asarray(xT.numpy())))
    log_q = core.mixture_logpdf_T(p0, xT).numpy()
    assert w.shape == (999,)
    np.testing.assert_allclose(w.numpy(), np.exp(log_p - log_q), rtol=1e-12, atol=0)


def test_per_point_target_adapts_as_the_same_mixture_target():
    """pmc_run_sharded with the per-point target draws the particles it
    draws with the target as MixtureParams, and adapts the mixture alike."""
    p0 = per_point_proposal()
    target = core.make_mixture(PP_MU, np.array([np.diag(v) for v in PP_VAR]), PP_W)[0]
    a = pmc_run_sharded(per_point_target(torch), p0, 1 << 12, 3, key=1, return_final_samples=True)
    b = pmc_run_sharded(target, p0, 1 << 12, 3, key=1, return_final_samples=True)
    np.testing.assert_allclose(a[2].numpy(), b[2].numpy(), rtol=1e-12, atol=1e-12)
    for f in ("means", "cov", "weights", "dof"):
        np.testing.assert_allclose(getattr(a[0], f).numpy(), getattr(b[0], f).numpy(),
                                   rtol=1e-10, atol=1e-12, err_msg=f)
    for x, y in zip(a[1], b[1]):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-10, err_msg="stats")


def test_multi_rank_group_is_refused(monkeypatch):
    _, _, tp, tt = problem()
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    with pytest.raises(NotImplementedError):
        pmc_run_sharded(tt, tp, 64, 1)


# ------------------------------------------------------------------ #
# pmc_run_sharded(scan_steps=True)                                    #
# ------------------------------------------------------------------ #

# label: (Student-t proposal, target, particles, keywords); below 1024
# particles the step draws with fused_propose_logq and updates unfused
SCAN_RUNS = {
    "gaussian mixture": (False, "mixture", 2000, {}),
    "student-t mixture": (True, "mixture", 2000, {}),
    "student-t, 1000 particles": (True, "mixture", 1000, {}),
    "batched callable": (True, "callable", 1500, {}),
    "rb=False": (True, "mixture", 1500, {"rb": False}),
    "weight_clip": (False, "mixture", 1500, {"weight_clip": True,
                                             "compute_log_likelihood": False}),
}


def scan_problem(run):
    student_t, kind, n, kw = SCAN_RUNS[run]
    _, _, tp, tt = problem(student_t)
    if kind == "callable":
        @batched_target(transposed=True)
        def target(xT):
            return core.mixture_logpdf_T(tt, xT)
        return target, tp, n, kw
    return tt, tp, n, kw


def assert_runs_equal(a, b):
    for f in core._FIELDS:
        x, y = getattr(a[0], f), getattr(b[0], f)
        assert (x is None and y is None) or torch.equal(x, y), f
    for x, y in zip(a[1], b[1]):
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("n_steps", [1, 4, 5, 9])
@pytest.mark.parametrize("run", list(SCAN_RUNS))
def test_scan_steps_equal_the_loop_across_chunks(monkeypatch, run, n_steps):
    """scan_steps=True through chunks of 4 steps equals the loop bit for
    bit: the mixture, all four statistics."""
    monkeypatch.setattr(_scan, "CHUNK", 4)
    psampler.clear_step_cache()
    target, tp, n, kw = scan_problem(run)
    loop = pmc_run_sharded(target, tp, n, n_steps, key=11, **kw)
    scan = pmc_run_sharded(target, tp, n, n_steps, key=11, scan_steps=True, **kw)
    assert scan[1].ess.shape == (n_steps,)
    assert_runs_equal(loop, scan)


def test_the_seed_table_holds_the_loops_words(monkeypatch):
    """The scan's steps take, in order, the words the loop's steps take:
    _rank_key's of the key's generator."""
    _, _, tp, tt = problem()
    seen = []
    step = psampler._pmc_step

    def spy(params, target, key, *args, **kwargs):
        seen.append(tuple(int(w) for w in key))
        return step(params, target, key, *args, **kwargs)

    monkeypatch.setattr(psampler, "_pmc_step", spy)
    monkeypatch.setattr(_scan, "CHUNK", 2)
    pmc_run_sharded(tt, tp, 1500, 5, key=4)
    loop, seen[:] = seen[:], []
    pmc_run_sharded(tt, tp, 1500, 5, key=4, scan_steps=True)
    gen = torch.Generator().manual_seed(4)
    assert seen == loop == [psampler._rank_key(gen, None) for _ in range(5)]


class StandInCard:
    """The card's part of a scan on the CPU: the warm-up runs the steps; a
    capture runs them for its checks (strict) and undoes what they wrote,
    as a capture records and runs nothing; a replay runs them anew, reading
    the buffers as they are then, without counting its launches (the scan
    adds the capture's)."""

    @staticmethod
    def serves(device):
        return True

    @staticmethod
    def warm_up(device, steps):
        steps()

    @staticmethod
    def capture(device, steps):
        scan = next(reversed(psampler._SCANS.values()))
        buffers = [t for group in scan._buffers for t in group]
        saved = [t.clone() for t in buffers]
        steps()
        for t, v in zip(buffers, saved):
            t.copy_(v)
        return steps

    @staticmethod
    def replay(graph):
        before = kernels.launch_counts()
        graph()
        kernels.add_launch_counts(_scan._launches_since(before), -1)


def wide_problem():
    """A D=40 draw no kernel makes below 1024 particles: the mixtures are
    past fused_propose_logq's rule (12 + 2 components), the transforms need
    1024 particles."""
    rng = np.random.default_rng(5)
    tp = core.make_mixture(rng.normal(0, 1, (12, 40)), np.array([np.eye(40)] * 12))[0]
    tt = core.make_mixture(rng.normal(0, 1, (2, 40)), np.array([np.eye(40) * 2] * 2))[0]
    return tp, tt


@pytest.mark.parametrize("n", [1000, 3000])
def test_replays_read_each_chunks_seeds(monkeypatch, n):
    """With a stand-in card, the graph of a 3-step chunk, captured once and
    replayed on each later chunk's seed words, gives the loop's run bit for
    bit and its launch counts (the plain routes below 1024 particles)."""
    monkeypatch.setattr(_scan.Scan, "_card", StandInCard)
    monkeypatch.setattr(_scan, "CHUNK", 3)
    psampler.clear_step_cache()
    _, _, tp, tt = problem()
    kernels.reset_launch_counts()
    loop = pmc_run_sharded(tt, tp, n, 10, key=8)
    want = kernels.launch_counts()
    _scan.reset_counts()
    kernels.reset_launch_counts()
    scan = pmc_run_sharded(tt, tp, n, 10, key=8, scan_steps=True)
    assert kernels.launch_counts() == want
    assert _scan.counts == {"replays": 3, "captures": 2, "warm-ups": 1, "uncapturable": 0,
                            "fallbacks": 0}
    assert_runs_equal(loop, scan)
    assert want["plain:fused_is_pmc_step"] == (10 if n < 1024 else 0)


def test_a_draw_no_kernel_makes_is_not_captured(monkeypatch, caplog):
    """The body in strict mode raises Uncapturable before it draws where no
    kernel draws; through the stand-in card the run falls back with one
    warning, counted, and equals the loop bit for bit."""
    tp, tt = wide_problem()
    settings = dict(n_local=1000, mesh=None, rb=True, steps=0, mindof=1e-5, maxdof=1e3,
                    compute_log_likelihood=True, weight_clip=False)
    drawn = []
    propose = core.propose_T
    monkeypatch.setattr(core, "propose_T", lambda *a: drawn.append(1) or propose(*a))
    seeds = torch.tensor([[1, 2]])
    ys = tuple(torch.empty(1, dtype=torch.float64) for _ in range(4))
    carry = psampler._tensors(tp)
    with pytest.raises(_scan.Uncapturable, match="no kernel's"):
        psampler._pmc_steps(settings, None, (seeds,), ys, carry, psampler._tensors(tt), True)
    assert not drawn
    psampler._pmc_steps(settings, None, (seeds,), ys, carry, psampler._tensors(tt), False)
    assert drawn == [1]
    # a kernel's draw is captured: the flagship's shapes
    _, _, fp, ft = problem()
    settings.update(steps=100)
    psampler._pmc_steps(settings, None, (seeds,), ys, psampler._tensors(fp),
                        psampler._tensors(ft), True)

    monkeypatch.setattr(_scan.Scan, "_card", StandInCard)
    monkeypatch.setattr(_scan, "CHUNK", 2)
    psampler.clear_step_cache()
    loop = pmc_run_sharded(tt, tp, 1000, 5, key=3)
    _scan.reset_counts()
    with caplog.at_level(logging.WARNING, logger=_scan.__name__):
        caplog.clear()
        scan = pmc_run_sharded(tt, tp, 1000, 5, key=3, scan_steps=True)
    warnings = [r.getMessage() for r in caplog.records if "cannot be captured" in r.getMessage()]
    assert len(warnings) == 1 and "no kernel's" in warnings[0]
    assert _scan.counts == {"replays": 0, "captures": 0, "warm-ups": 1, "uncapturable": 1,
                            "fallbacks": 2}
    assert_runs_equal(loop, scan)


def test_a_seed_tensor_draws_what_its_words_draw():
    """The plain versions of the three kernels a replayed step seeds from
    its table draw from a 2-word int64 tensor what they draw from the same
    words as ints."""
    rng = np.random.default_rng(6)
    tp = core.make_mixture(rng.normal(0, 1, (3, 4)), np.array([np.eye(4)] * 3), None,
                           np.full(3, 6.0))[0]
    tt = core.make_mixture(rng.normal(0, 1, (2, 4)), np.array([np.eye(4)] * 2))[0]
    ops, tops = core._kernel_operands(tp), core._kernel_operands(tt)
    words = (0x9E3779B9, 12345)
    table = torch.tensor(words)
    calls = [lambda s: kernels.fused_propose_logq(s, ops, 500, tops),
             lambda s: kernels.fused_is_pmc_step(s, ops, tops, 500, True),
             lambda s: kernels.fused_is_pmc_step_blocked(s, ops, tops, 500, True)]
    for call in calls:
        a, b = call(words), call(table)
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            if isinstance(x, dict):
                assert all(torch.equal(x[key], y[key]) for key in x)
            else:
                assert torch.equal(x, y)
