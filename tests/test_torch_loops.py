"""The port's device loops and the float32 VB stopping rule, on the CPU.

* The float32 VB fit of ``examples/variational.py``'s mixture converges
  wherever the JAX package's float32 fit (x64 off) does, seeds 1-13, to
  the same two components.
* ``ops.kernels.solve_dofs`` (its plain version here) against the JAX
  package's ``_solve_dofs`` in float64, and the PMC entry points reach it.
* The chains' runs (``sampler._scan.Scan``): chunked through fixed
  buffers they equal the unchunked loop bit for bit; with a stand-in for
  the card, the launch counts add each capture's launches per replay, and
  a step that cannot be captured falls back to the eager loop with one
  warning.

Run as a script, it prints the seeds' iteration counts (both packages,
float32, and the port's float64).
"""

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pypmc_tpu as jpt
import pypmc_tpu.mix_adapt.pmc as jpmc
import pypmc_tpu_torch
from pypmc_tpu_torch.density import LocalGauss, LocalStudentT, create_gaussian_mixture
from pypmc_tpu_torch.mix_adapt import VBMerge, pmc, variational
from pypmc_tpu_torch.mix_adapt.variational import GaussianInference
from pypmc_tpu_torch.ops import kernels
from pypmc_tpu_torch.sampler import MarkovChain, _scan, markov_chain, sample_adaptive_chains

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port runs on the card unless the CPU is asked for: ask for it."""
    with pypmc_tpu_torch.using_device("cpu"):
        yield


# ------------------------------------------------------------------ #
# the float32 VB stopping rule                                        #
# ------------------------------------------------------------------ #

def example_data(seed, n=500):
    """``examples/variational.py``'s ``n`` draws (500 there), with seed
    ``seed``."""
    mix = jpt.density.create_gaussian_mixture(
        [np.array([5.0, 0.01]), np.array([-4.0, 1.0])],
        [np.array([[0.01, 0.003], [0.003, 0.0025]]), np.array([[0.1, 0.0], [0.0, 0.02]])],
        np.array([0.3, 0.7]))
    return np.asarray(mix.propose(n, rng=seed))


def fits(seed):
    """``(JAX float32, port float32)``: each ``(iteration or None, mixture)``
    of ``GaussianInference(data, 20).run(100)``."""
    data = example_data(seed)
    with jax.enable_x64(False):
        jvb = jpt.mix_adapt.GaussianInference(data, 20)
        jax_fit = jvb.run(100), jvb.make_mixture()
    vb = GaussianInference(torch.tensor(data, dtype=torch.float32), 20)
    return jax_fit, (vb.run(100), vb.make_mixture())


@pytest.mark.parametrize("seed", range(1, 14))
def test_float32_fit_stops_where_the_jax_packages_does(seed):
    """Where the JAX package's float32 fit of the example's data converges,
    the port's float32 fit converges too, to the same two components.  The
    port's hyperparameters are float64 and the JAX package's float32, and
    both sum the 500 points in float32: weights and means agree to 3e-5
    relative, 500 times float32's epsilon (a float32 sum of 500 terms)."""
    (j_iter, j_mix), (t_iter, t_mix) = fits(seed)
    assert j_iter is not None
    assert t_iter is not None, "the port's float32 fit did not converge (JAX: %d)" % j_iter
    assert len(j_mix) == len(t_mix) == 2
    order_j, order_t = np.argsort(j_mix.weights), np.argsort(t_mix.weights)
    np.testing.assert_allclose(np.asarray(t_mix.weights)[order_t],
                               np.asarray(j_mix.weights)[order_j], rtol=3e-5)
    for a, b in zip(order_t, order_j):
        np.testing.assert_allclose(t_mix.components[a].mu, j_mix.components[b].mu,
                                   rtol=3e-5, atol=3e-5)


def test_held_operands():
    """The one-pass E-step's float32 operands: a component keeps the held
    ones while every new value is within one float32 spacing of its scale,
    and takes the new ones, rounded, once one value moves further; float64
    data takes the float64 operands as they are."""
    rng = np.random.default_rng(5)
    A = torch.tensor(np.triu(rng.normal(size=(3, 2, 2))) + 3 * np.eye(2))
    m, const = torch.tensor(rng.normal(size=(3, 2))), torch.tensor(rng.normal(size=3))
    scales = (A.abs().amax(dim=(1, 2)), m.abs().amax(dim=1), const.abs())
    held = tuple(v.float() for v in (A, m, const))
    step = variational._spacing(scales[0], torch.float32)
    moved = A.clone()
    moved[0, 0, 1] += 0.9 * step[0]        # within the band: component 0 keeps
    moved[1, 1, 1] += 1.5 * step[1]        # past it: component 1 takes the new ones
    got = variational._held_operands((moved, m, const), scales, held, torch.float32)
    assert torch.equal(got[0][0], held[0][0]) and torch.equal(got[0][2], held[0][2])
    assert torch.equal(got[0][1], moved[1].float())
    assert all(torch.equal(g, h) for g, h in zip(got[1:], held[1:]))
    assert all(torch.equal(g, v.float()) for g, v in zip(
        variational._held_operands((moved, m, const), scales, None, torch.float32),
        (moved, m, const)))
    kernels.reset_launch_counts()
    x = torch.tensor(rng.normal(size=(2, 1100)))
    e = variational._vb_e_step_fused(x, torch.ones(1100, dtype=torch.float64),
                                     *GaussianInference(x.T, 3)._posterior(), held=held)
    assert all(o.dtype == torch.float64 for o in e.operands)


def test_the_one_pass_e_step_takes_1024_points_or_more():
    """The JAX package's GaussianInference takes its one-pass E-step from
    1024 points (``variational.py:743``); below, its statistics are direct
    sums over the data.  The port routes alike, counting the refusal as
    plain:fused_vb_estep."""
    rng = np.random.default_rng(4)
    for n, route in ((1023, None), (1024, "dense")):
        kernels.reset_launch_counts()
        vb = GaussianInference(rng.normal(size=(n, 2)), 3)
        assert kernels.launch_counts()["plain:fused_vb_estep"] == (route is None)
        assert (vb._e.r is None) == (route == "dense")
        assert vb._fused_eligible() == route
    assert kernels.refusal("fused_vb_estep", 3, 2, n=1023) is not None
    assert kernels.fits("fused_vb_estep", 3, 2, n=1024) and kernels.fits("fused_vb_estep", 3, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_vbmerge_reduces_in_either_dtype(dtype):
    """VBMerge inherits run(): 20 input components of two clusters reduce
    to 2, converged, in float32 as in float64 (weights to float32's 1e-6)."""
    rng = np.random.default_rng(3)
    means = np.vstack([rng.normal([0, 0], 0.3, size=(10, 2)),
                       rng.normal([5, 5], 0.3, size=(10, 2))])
    mix = create_gaussian_mixture(means, np.array([np.eye(2) * 0.5] * 20))
    fits = {}
    for dt in (dtype, torch.float64):
        vb = VBMerge(mix, 1000, components=20, dtype=dt)
        fits[dt] = vb.run(100), vb.make_mixture()
    (converged, got), (_, want) = fits[dtype], fits[torch.float64]
    assert converged is not None and len(got) == len(want) == 2
    np.testing.assert_allclose(np.sort(got.weights), np.sort(want.weights), rtol=1e-6)


# ------------------------------------------------------------------ #
# the dof solve                                                       #
# ------------------------------------------------------------------ #

MINDOF, MAXDOF = 1e-5, 1e3


def dof_constants(K, seed):
    """Seeded constants with, where K allows, a NaN, +-inf and a constant
    past each clamp: c > 0 has no root (maxdof), c < -2e5 none above
    mindof (mindof)."""
    c = np.random.default_rng(seed).uniform(-2.0, 0.3, K)
    specials = [np.nan, np.inf, -np.inf, 0.5, -3e5]
    c[:min(K, len(specials))] = specials[:K] if K < len(specials) else specials
    return c


@pytest.mark.parametrize("K", [1, 10, 400])
@pytest.mark.parametrize("steps", [1, 100])
def test_solve_dofs_against_the_jax_package(K, steps):
    """kernels.solve_dofs on the CPU (its plain version) against the JAX
    package's _solve_dofs in float64: the two digammas round differently,
    so a bisection step may go the other way where the condition is within
    rounding of 0; the roots agree to 1e-9 relative, the clamped, NaN and
    infinite entries exactly."""
    c = dof_constants(K, K + steps)
    old = np.random.default_rng(1).uniform(2.0, 30.0, K)
    ref = np.asarray(jpmc._solve_dofs(jnp.asarray(c), jnp.asarray(old), steps, MINDOF, MAXDOF,
                                      jnp.float64))
    kernels.reset_launch_counts()
    got = kernels.solve_dofs(torch.tensor(c), torch.tensor(old), steps, MINDOF, MAXDOF).numpy()
    assert kernels.launch_counts()["solve_dofs"] == 0      # the plain version ran
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=0)
    special = ~np.isfinite(c) | (c > 0) | (c < -2e5)
    np.testing.assert_array_equal(got[special], ref[special])
    # a NaN never goes right: its root is within an ulp of mindof once the
    # bracket is below mindof's resolution (80 steps in float64)
    assert list(got[1:5]) == [MAXDOF, MINDOF, MAXDOF, MINDOF][:K - 1]
    assert abs(got[0] - MINDOF) <= (np.spacing(MINDOF) if steps == 100 else MAXDOF / 2)


def test_solve_dofs_dispatch():
    """A CPU tensor takes the plain version, in any float dtype; a tensor on
    another device type raises, as do tensors on two devices."""
    c, old = torch.tensor([-0.3, 0.5]), torch.tensor([4.0, 5.0])
    assert kernels.solve_dofs(c, old, 100, MINDOF, MAXDOF).dtype == torch.float32
    torch.testing.assert_close(kernels.solve_dofs(c, old, 100, MINDOF, MAXDOF),
                               kernels.plain_solve_dofs(c, old, 100, MINDOF, MAXDOF),
                               rtol=0, atol=0)
    with pytest.raises(TypeError, match="device type"):
        kernels.solve_dofs(c.to("meta"), old.to("meta"), 100, MINDOF, MAXDOF)
    with pytest.raises(ValueError, match="different devices"):
        kernels.solve_dofs(c, old.to("meta"), 100, MINDOF, MAXDOF)


def warp_schedule(const, old_dofs, steps, mindof, maxdof, levels=5):
    """A tensor emulation of ``csrc/solve_dofs.cu``'s warp kernel, all
    components at once: rounds of ``levels`` levels of the bisection tree
    (a shorter last round), node j of a round (breadth first) evaluated at
    the midpoint of the bracket derived from the round's by the updates of
    its path, the round's bits walked down the taken path; f_lo and f_hi on
    the lanes the round's nodes leave of a warp's 32, in a round of their
    own where none are left.  Each condition is evaluated on a (K,) tensor,
    as the plain version evaluates its own."""
    def condition(nu):
        return const + torch.log(0.5 * nu) - torch.special.digamma(0.5 * nu)

    lo, hi = torch.full_like(const, mindof), torch.full_like(const, maxdof)
    ends, s = [], 0      # the end conditions' bits: f_lo < 0, f_hi > 0
    while s < steps or len(ends) < 2:
        depth = min(levels, steps - s)
        nodes = (1 << depth) - 1
        bits = []
        for j in range(nodes):
            a, b = lo, hi
            for i in range((j + 1).bit_length() - 2, -1, -1):
                mid = 0.5 * (a + b)
                a, b = (mid, b) if ((j + 1) >> i) & 1 else (a, mid)
            bits.append(condition(0.5 * (a + b)) > 0)
        for e in range(len(ends), min(2, len(ends) + 32 - nodes)):
            f = condition(torch.full_like(const, (mindof, maxdof)[e]))
            ends.append(f < 0 if e == 0 else f > 0)
        node = torch.zeros(const.shape, dtype=torch.long)
        for _ in range(depth):
            mid = 0.5 * (lo + hi)
            right = torch.stack(bits).gather(0, node[None])[0]
            lo, hi = torch.where(right, mid, lo), torch.where(right, hi, mid)
            node = 2 * node + 1 + right.long()
        s += depth
    root = 0.5 * (lo + hi)
    root = torch.where(ends[0], torch.full_like(root, mindof), root)
    root = torch.where(ends[1], torch.full_like(root, maxdof), root)
    return torch.where(torch.isfinite(root), root, old_dofs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("steps", [0, 1, 5, 7, 100])
@pytest.mark.parametrize("K", [1, 10, 400])
def test_the_warp_kernels_schedule_equals_the_plain_version(K, steps, dtype):
    """The warp kernel's schedule of the bisection (five levels a round)
    gives the serial bisection's roots bit for bit, in float32 and float64:
    NaN, +-inf, a constant past each clamp, and roots at mindof and maxdof
    (constants whose condition is 0 there) among seeded ones."""
    from scipy.special import digamma

    c = dof_constants(K, 7 * K + steps)
    ends = [digamma(x / 2) - np.log(x / 2) for x in (MINDOF, MAXDOF)]
    c[5:7] = ends[:max(0, K - 5)]
    const = torch.tensor(c, dtype=dtype)
    old = torch.tensor(np.random.default_rng(3).uniform(2.0, 30.0, K), dtype=dtype)
    got = warp_schedule(const, old, steps, MINDOF, MAXDOF)
    want = kernels.plain_solve_dofs(const, old, steps, MINDOF, MAXDOF)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(got[~torch.isnan(got)], want[~torch.isnan(want)])
    for variant in ("warp", "serial"):
        assert torch.equal(kernels.solve_dofs(const, old, steps, MINDOF, MAXDOF, variant), want)
    with pytest.raises(ValueError, match="no variant"):
        kernels.solve_dofs(const, old, steps, MINDOF, MAXDOF, "looped")


def test_student_t_updates_reach_solve_dofs(monkeypatch):
    """pmc_update (one-pass and unfused) and pmc_step_mixture_target solve
    the dofs through kernels.solve_dofs, once an update; a Gaussian update
    and dof_solver_steps=0 do not."""
    calls = []

    def spy(*args):
        calls.append(args[2])
        return kernels.plain_solve_dofs(*args)

    monkeypatch.setattr(kernels, "solve_dofs", spy)
    rng = np.random.default_rng(2)
    t = create_gaussian_mixture(rng.normal(size=(3, 2)), [np.eye(2)] * 3)
    g = t.stacked_params()
    st = pypmc_tpu_torch.density.create_t_mixture(
        rng.normal(size=(3, 2)), [np.eye(2)] * 3, [5.0, 6.0, 7.0]).stacked_params()
    x = torch.tensor(rng.normal(size=(2, 300)))
    pmc.pmc_update(st, x, transposed=True)
    pmc.pmc_update(st, x, transposed=True, fused="off", dof_solver_steps=7)
    pmc.pmc_step_mixture_target(st, g, 0, 500)
    pmc.pmc_update(g, x, transposed=True)
    pmc.pmc_update(st, x, transposed=True, dof_solver_steps=0)
    assert calls == [100, 7, 100]


# ------------------------------------------------------------------ #
# the chains' runs                                                    #
# ------------------------------------------------------------------ #

C = 7    # steps a chunk in these tests


def target(x):
    return -0.5 * torch.sum((x - 1.0) ** 2) / 0.3


def chain(proposal_kind, seed=5):
    sigma = np.array([[0.5, 0.1], [0.1, 0.3]])
    proposal = LocalGauss(sigma) if proposal_kind == "gauss" else LocalStudentT(sigma, 4.0)
    return MarkovChain(target, proposal, np.zeros(2), save_target_values=True, rng=seed)


def run_chain(monkeypatch, chunk, kind, runs):
    monkeypatch.setattr(_scan, "CHUNK", chunk)
    mc = chain(kind)
    accepts = [mc.run(n) for n in runs]
    return accepts, mc.samples[:], mc.target_values[:], mc.current_point


@pytest.mark.parametrize("kind", ["gauss", "student_t"])
@pytest.mark.parametrize("n", [C - 3, C, C + 1])
def test_chunked_chain_equals_the_unchunked_loop(monkeypatch, kind, n):
    """A chain's runs through C-step chunks equal the same runs in one
    chunk, bit for bit (the second run reuses the chain's scan), and one
    run in one chunk equals the step function run directly on the draws."""
    chunked = run_chain(monkeypatch, C, kind, [n, n + 2 * C])
    whole = run_chain(monkeypatch, 10**6, kind, [n, n + 2 * C])
    assert chunked[0] == whole[0]
    for a, b in zip(chunked[1:], whole[1:]):
        np.testing.assert_array_equal(a, b)

    mc = chain(kind)
    gen = torch.Generator().manual_seed(0)
    delta = torch.randn((n, 2), generator=gen, dtype=torch.float64)
    log_u = torch.log(torch.rand((n,), generator=gen, dtype=torch.float64))
    start = torch.zeros(2, dtype=torch.float64)
    carry = (start, target(start), torch.zeros((), dtype=torch.int64),
             torch.zeros((), dtype=torch.bool))
    outs = [(torch.empty((n, 2), dtype=torch.float64), torch.empty(n, dtype=torch.float64))
            for _ in range(2)]
    body = functools.partial(markov_chain._chain_steps, mc.target)
    monkeypatch.setattr(_scan, "CHUNK", C)
    got = _scan.Scan(body).run((delta, log_u), outs[0], carry)
    ref = tuple(t.clone() for t in carry)
    body((delta, log_u), outs[1], ref, (), False)
    for a, b in zip(outs[0] + got, outs[1] + ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [C - 3, C, C + 1])
def test_chunked_tensor_pool_equals_the_unchunked_loop(monkeypatch, n):
    """sample_adaptive_chains' tensor pool (a per-point callable target,
    mapped with torch.func.vmap) through C-step chunks equals it in one
    chunk a cycle, bit for bit, Gaussian and Student-t proposals."""
    starts = np.random.default_rng(3).normal(size=(4, 2))
    for dof in (None, 5.0):
        runs = []
        for chunk in (C, 10**6):
            monkeypatch.setattr(_scan, "CHUNK", chunk)
            runs.append(sample_adaptive_chains(target, starts, np.eye(2) * 0.5, n, 3,
                                               key=11, dof=dof))
        for a, b in zip(*runs):
            assert torch.equal(a, b)


class StandInCard:
    """The card's part of a scan on the CPU: the warm-up and a capture run
    the steps (a capture's for its Python side effects: its tensor work
    also runs here, where a capture would only record it); a replay runs
    nothing.  ``fail`` is raised by a capture, as CUDA would raise it."""

    fail = None

    @staticmethod
    def serves(device):
        return True

    @staticmethod
    def warm_up(device, steps):
        steps()

    @classmethod
    def capture(cls, device, steps):
        if cls.fail is not None:
            raise cls.fail
        steps()
        return "graph"

    @staticmethod
    def replay(graph):
        assert graph == "graph"


def test_replays_count_the_launches_they_make(monkeypatch):
    """With a stand-in wrapper (the target counts a fused_logq launch a
    call, as the wrapper does where it launches): the warm-up chunk counts
    its launches, a capture's are taken back, and each replay adds the
    captured chunk's, so the count is one a step."""
    monkeypatch.setattr(_scan.Scan, "_card", StandInCard)
    monkeypatch.setattr(_scan, "CHUNK", C)

    def counted(x):
        kernels.fused_logq.launches += 1
        return target(x)

    mc = MarkovChain(counted, LocalGauss(np.eye(2) * 0.3), np.zeros(2), rng=1)
    kernels.reset_launch_counts()
    _scan.reset_counts()
    mc.run(3 * C + 2)
    mc.run(C)
    assert kernels.launch_counts()["fused_logq"] == 4 * C + 2
    assert _scan.counts == {"replays": 4, "captures": 2, "warm-ups": 1, "uncapturable": 0,
                            "fallbacks": 0}
    kernels.add_launch_counts({"fused_logq": 5, "variant:fused_mcmc_pool=warp": 2}, -1)
    counts = kernels.launch_counts()
    assert counts["fused_logq"] == 4 * C - 3 and counts["variant:fused_mcmc_pool=warp"] == -2


@pytest.mark.parametrize("fail", [None, RuntimeError(
    "CUDA error: operation not permitted when stream is capturing")])
def test_a_step_that_cannot_be_captured_runs_eagerly(monkeypatch, caplog, fail):
    """A target returning a Python number (check_capturable, while
    captured) or a capture error from CUDA: one warning naming the cause,
    the counts say so, and the run equals the chunked CPU run bit for bit.
    Any other error of a capture propagates."""
    runs = []
    for card in (_scan._Card, StandInCard):
        monkeypatch.setattr(_scan.Scan, "_card", card)
        monkeypatch.setattr(StandInCard, "fail", fail)
        monkeypatch.setattr(_scan, "CHUNK", C)
        host = (lambda x: float(target(x))) if fail is None else target
        mc = MarkovChain(host, LocalGauss(np.eye(2) * 0.3), np.zeros(2), rng=4)
        _scan.reset_counts()
        with caplog.at_level(logging.WARNING, logger=_scan.__name__):
            caplog.clear()
            runs.append((mc.run(3 * C), mc.samples[:]))
    assert runs[0][0] == runs[1][0]
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
    warnings = [r for r in caplog.records if "cannot be captured" in r.getMessage()]
    assert len(warnings) == 1
    assert ("not a tensor" if fail is None else "stream is capturing") in warnings[0].getMessage()
    assert _scan.counts == {"replays": 0, "captures": 0, "warm-ups": 1, "uncapturable": 1,
                            "fallbacks": 2}

    monkeypatch.setattr(StandInCard, "fail", RuntimeError("an error of the target"))
    mc = MarkovChain(target, LocalGauss(np.eye(2) * 0.3), np.zeros(2), rng=4)
    with pytest.raises(RuntimeError, match="an error of the target"):
        mc.run(2 * C)


def test_check_capturable():
    like = torch.zeros(2)
    _scan.check_capturable(torch.zeros(()), like)
    for value in (1.5, torch.zeros((), device="meta")):
        with pytest.raises(_scan.Uncapturable, match="not a tensor on cpu"):
            _scan.check_capturable(value, like)


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    pypmc_tpu_torch.set_default_device("cpu")
    logging.disable(logging.WARNING)
    print("seed  JAX float32  port float32  port float64 (iterations; None: not converged)")
    for seed in range(1, 14):
        (j_iter, _), (t_iter, _) = fits(seed)
        vb64 = GaussianInference(example_data(seed), 20)
        print("%4d  %11s  %12s  %12s" % (seed, j_iter, t_iter, vb64.run(100)))
