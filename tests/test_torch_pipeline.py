"""pypmc_tpu_torch.pipeline.integrate, pypmc_tpu_torch.checkpoint and the
port's device rule, against the JAX package where the two can be held
side by side: the evidence at tests/test_pipeline_api.py's sizes, and a
resume from the JAX package's own checkpoint files, which carries the
chain pool across and must give the same long-patches and VB1 mixtures."""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

import pypmc_tpu as jpt
import pypmc_tpu.checkpoint as jcheckpoint
import pypmc_tpu_torch
import pypmc_tpu_torch.density as td
from pypmc_tpu_torch import checkpoint
from pypmc_tpu_torch.density import core
from pypmc_tpu_torch.mix_adapt import GaussianInference, VBMerge, make_r_gaussmix
from pypmc_tpu_torch.ops import kernels
from pypmc_tpu_torch.pipeline import integrate

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port runs on the card unless the CPU is asked for: ask for it."""
    with pypmc_tpu_torch.using_device("cpu"):
        yield


def bimodal(pkg, dim):
    """tests/test_pipeline_api.py's target: evidence 1."""
    means = np.stack([np.zeros(dim), np.full(dim, 3.0)])
    covs = np.array([np.eye(dim) * 0.7] * 2)
    return pkg.density.create_gaussian_mixture(means, covs, np.array([0.4, 0.6]))


def make_starts(dim, n=12, seed=0):
    rng = np.random.default_rng(seed)
    return np.vstack([rng.normal(0, 1.5, (n // 2, dim)), rng.normal(3, 1.5, (n // 2, dim))])


SMALL = dict(mcmc_steps=200, mcmc_cycles=6, n_is1=1 << 14, n_is2=1 << 15, pmc_steps=5)


def within_three_sigma(r):
    assert abs(r.evidence - 1.0) < 3 * r.uncertainty, (r.evidence, r.uncertainty)


def test_integrate_mixture_target():
    """test_integrate_mixture_target's run: the analytic evidence within 3
    Monte Carlo sigma, a live Student-t proposal, the stage details."""
    r = integrate(bimodal(pypmc_tpu_torch, 3), 3, make_starts(3), key=0, **SMALL)
    within_three_sigma(r)
    assert r.uncertainty < 0.03 and r.ess > 0.2
    assert r.n_samples == (1 << 14) + (1 << 15)
    assert r.samples.shape == (r.n_samples, 3) and r.weights.shape == (r.n_samples,)
    assert len(r.proposal) >= 1 and r.proposal.kind == "student_t"
    for key in ("mcmc_s", "vb1_K", "vb2_K", "final_K", "is1_vb2_s", "is2_combine_s"):
        assert key in r.details
    curve = r.details["pmc_perplexity_curve"]
    assert len(curve) == 5 and curve[-1] > curve[0] * 0.5


def test_integrate_float32_mixture_takes_the_kernel_routes(monkeypatch):
    """A float32 MixtureParams target takes the card's routes on the CPU:
    fused_mcmc_pool once a cycle, the IS runs through fused_propose_logq."""
    seen = []
    for name in ("fused_mcmc_pool", "fused_propose_logq", "fused_vb_estep"):
        def spy(*args, _name=name, _fn=getattr(kernels, name), **kwargs):
            seen.append(_name)
            return _fn(*args, **kwargs)
        monkeypatch.setattr(kernels, name, spy)
    target = bimodal(pypmc_tpu_torch, 3).stacked_params(dtype=torch.float32)
    r = integrate(target, 3, make_starts(3), key=1, **SMALL)
    assert seen.count("fused_mcmc_pool") == SMALL["mcmc_cycles"]
    assert seen.count("fused_propose_logq") >= 2 + SMALL["pmc_steps"]
    assert "fused_vb_estep" in seen
    within_three_sigma(r)


def test_integrate_callable_target():
    """test_integrate_callable_target's run: a per-point target (tensor
    pool, PMC host driver)."""
    fn = bimodal(pypmc_tpu_torch, 2).evaluate_fn()
    r = integrate(fn, 2, make_starts(2), key=2, mcmc_steps=200, mcmc_cycles=5,
                  n_is1=1 << 13, n_is2=1 << 14, pmc_steps=2)
    within_three_sigma(r)
    assert r.n_samples == (1 << 13) + (1 << 14)


def test_integrate_validates_and_raises():
    target = bimodal(pypmc_tpu_torch, 3)
    with pytest.raises(ValueError, match="starts"):
        integrate(target, 3, np.zeros((4, 4)))
    with pytest.raises(ValueError, match="not finite"):
        integrate(target, 3, np.full((4, 3), np.nan))
    with pytest.raises(TypeError, match="particle mesh"):
        integrate(target, 3, make_starts(3), mesh=object())
    r = integrate(target, 2 + 1, make_starts(3), key=3, return_samples=False,
                  mcmc_steps=200, mcmc_cycles=5, n_is1=1 << 12, n_is2=1 << 13, pmc_steps=0)
    assert r.samples is None and r.n_samples == (1 << 12) + (1 << 13)
    assert "pmc_perplexity_curve" not in r.details


def test_integrate_checkpoint_resume(tmp_path):
    """Each completed stage is saved; a re-run resumes from the furthest
    one; a checkpoint written under other settings is rejected."""
    ck = str(tmp_path / "ck")
    kwargs = dict(SMALL, checkpoint_dir=ck)
    target = bimodal(pypmc_tpu_torch, 3)
    r1 = integrate(target, 3, make_starts(3), key=4, **kwargs)
    assert r1.details["resumed_stages"] == []
    assert sorted(os.listdir(ck)) == ["mcmc.npz", "refined_mixture.npz", "vb1.npz",
                                      "vb1_mixture.npz"]
    r2 = integrate(target, 3, make_starts(3), key=4, **kwargs)
    assert r2.details["resumed_stages"] == ["mcmc", "vb1", "refined"]
    assert r2.n_samples == 1 << 15
    within_three_sigma(r2)
    os.remove(os.path.join(ck, "refined_mixture.npz"))
    r3 = integrate(target, 3, make_starts(3), key=4, **kwargs)
    assert r3.details["resumed_stages"] == ["mcmc", "vb1"]
    within_three_sigma(r3)
    for name in ("refined_mixture.npz", "vb1.npz", "vb1_mixture.npz"):
        os.remove(os.path.join(ck, name))
    with pytest.raises(ValueError, match="different pipeline configuration"):
        integrate(target, 3, make_starts(3), **dict(kwargs, mcmc_steps=400))


def test_integrate_resumes_from_the_jax_packages_checkpoint(tmp_path):
    """The carried state: the JAX package's integrate writes its stage
    checkpoints; the port, resumed from that chain pool (its mcmc.npz),
    builds the same long-patches mixture and, in float64, the same VB1
    mixture to 1e-8, and it resumes from the JAX package's refined
    proposal."""
    kwargs = dict(mcmc_steps=200, mcmc_cycles=6, n_is1=1 << 12, n_is2=1 << 13, pmc_steps=2)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jpt.pipeline.integrate(bimodal(jpt, 3), 3, make_starts(3), key=jax.random.PRNGKey(0),
                           checkpoint_dir=jdir, **kwargs)
    os.makedirs(tdir)
    shutil.copy(os.path.join(jdir, "mcmc.npz"), tdir)
    r = integrate(bimodal(pypmc_tpu_torch, 3), 3, make_starts(3), key=5,
                  checkpoint_dir=tdir, **kwargs)
    assert r.details["resumed_stages"] == ["mcmc"]
    within_three_sigma(r)

    with np.load(os.path.join(jdir, "mcmc.npz")) as data:
        pool = data["pool"]
    burn = kwargs["mcmc_steps"] * kwargs["mcmc_cycles"] // 2
    chains = [c[burn:] for c in pool]
    got = make_r_gaussmix(chains, K_g=1)
    ref = jpt.mix_adapt.make_r_gaussmix(chains, K_g=1)
    assert len(got) == len(ref) == r.details["patches_K"]
    for a, b in zip(got.components, ref.components):
        np.testing.assert_allclose(a.mu, b.mu, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(a.sigma, b.sigma, rtol=1e-12, atol=1e-12)

    vb_port = checkpoint.load_mixture(os.path.join(tdir, "vb1_mixture.npz"))
    vb_jax = jcheckpoint.load_mixture(os.path.join(jdir, "vb1_mixture.npz"))
    assert len(vb_port) == len(vb_jax) == r.details["vb1_K"]
    np.testing.assert_allclose(vb_port.weights, vb_jax.weights, rtol=1e-8, atol=1e-8)
    for a, b in zip(vb_port.components, vb_jax.components):
        np.testing.assert_allclose(a.mu, b.mu, rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(a.sigma, b.sigma, rtol=1e-8, atol=1e-8)

    # the JAX package's refined proposal: only the final run
    r2 = integrate(bimodal(pypmc_tpu_torch, 3), 3, make_starts(3), key=6,
                   checkpoint_dir=jdir, **kwargs)
    assert r2.details["resumed_stages"] == ["mcmc", "vb1", "refined"]
    assert r2.n_samples == 1 << 13
    within_three_sigma(r2)


# ------------------------------------------------------------------ #
# the device rule                                                     #
# ------------------------------------------------------------------ #

def test_without_cuda_the_entry_points_raise_unless_the_cpu_is_asked_for(monkeypatch):
    """The card unless the CPU is asked for: without CUDA, and without
    asking, the entry points raise rather than run on the host; asked on
    the call, with set_default_device or with using_device, they run the
    plain versions in float64."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(0)
    data = rng.normal(size=(60, 2))
    mix = td.create_gaussian_mixture([np.zeros(2), np.ones(2)], [np.eye(2)] * 2)
    calls = {
        "GaussianInference": lambda **kw: GaussianInference(data, 2, **kw),
        "VBMerge": lambda **kw: VBMerge(mix, 100, components=2, **kw),
        "stacked_params": lambda **kw: mix.stacked_params(**kw),
        "integrate": lambda **kw: integrate(mix, 2, make_starts(2), mcmc_steps=20,
                                            mcmc_cycles=2, n_is1=256, n_is2=256,
                                            pmc_steps=1, **kw),
        "params_from_numpy": lambda **kw: core.params_from_numpy(mix, **kw),
    }
    with pypmc_tpu_torch.using_device(None):
        for name, call in calls.items():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
        # asked for on the call
        assert GaussianInference(data, 2, device="cpu").dim == 2
        assert mix.stacked_params(device="cpu").means.dtype == torch.float64
        pypmc_tpu_torch.set_default_device("cpu")
        try:
            assert VBMerge(mix, 100, components=2).device.type == "cpu"
        finally:
            pypmc_tpu_torch.set_default_device(None)
        with pytest.raises(RuntimeError):
            mix.stacked_params()
        with pypmc_tpu_torch.using_device("cpu"):
            for name, call in calls.items():
                call()
    # a tensor keeps its device
    x = torch.tensor(data, dtype=torch.float32)
    assert GaussianInference(x, 2).data.dtype == torch.float32


# ------------------------------------------------------------------ #
# checkpoint                                                          #
# ------------------------------------------------------------------ #

MEANS = np.array([[0.0, 0.0], [3.0, 1.0]])
COVS = np.array([np.eye(2), [[2.0, 0.3], [0.3, 0.5]]])
WEIGHTS = np.array([0.3, 0.7])


def test_atomic_savez_rejects_object_arrays(tmp_path):
    path = tmp_path / "ck.npz"
    checkpoint.atomic_savez(path, a=np.arange(3), b=torch.ones(2))
    with np.load(path) as f:
        assert f["a"].tolist() == [0, 1, 2] and f["b"].tolist() == [1.0, 1.0]
    with pytest.raises(TypeError, match="'ragged'"):
        checkpoint.atomic_savez(tmp_path / "bad.npz", good=np.ones(2),
                                ragged=np.array([np.ones(2), np.ones(3)], dtype=object))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ck.npz"]
    assert checkpoint.is_primary_process()


@pytest.mark.parametrize("student_t", [False, True])
def test_mixture_files_are_shared_with_the_jax_package(tmp_path, student_t):
    """A mixture saved by either package loads in the other with the same
    parameters and log-density."""
    dofs = [4.0, 9.0]
    make = lambda pkg: (pkg.density.create_t_mixture(MEANS, COVS, dofs, WEIGHTS) if student_t
                        else pkg.density.create_gaussian_mixture(MEANS, COVS, WEIGHTS))
    x = np.array([[0.3, 0.6], [2.0, 1.0]])
    checkpoint.save_mixture(tmp_path / "port.npz", make(pypmc_tpu_torch))
    jcheckpoint.save_mixture(tmp_path / "jax.npz", make(jpt))
    for path in ("port.npz", "jax.npz"):
        got = checkpoint.load_mixture(tmp_path / path)
        ref = jcheckpoint.load_mixture(tmp_path / path)
        np.testing.assert_allclose(got.multi_evaluate(x), ref.multi_evaluate(x), rtol=1e-12)
        np.testing.assert_allclose(got.weights, WEIGHTS, rtol=1e-12)
    params = checkpoint.load_mixture_params(tmp_path / "jax.npz")
    assert params.is_student_t == student_t and params.means.dtype == torch.float64
    checkpoint.save_mixture(tmp_path / "params.npz", params)
    np.testing.assert_allclose(checkpoint.load_mixture(tmp_path / "params.npz").evaluate(x[0]),
                               make(pypmc_tpu_torch).evaluate(x[0]), rtol=1e-12)


def test_vb_and_chain_state_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    data = np.vstack([rng.normal(0, 1, (40, 2)), rng.normal(5, 1, (30, 2))])
    vb = GaussianInference(data, components=4)
    vb.run(iterations=5, prune=0.0)
    bound = vb.likelihood_bound()
    checkpoint.save_vb(tmp_path / "vb.npz", vb)
    vb2 = checkpoint.load_vb(tmp_path / "vb.npz", data)
    assert vb2.K == vb.K
    assert vb2.likelihood_bound() == pytest.approx(bound, rel=1e-10)
    vb2.run(iterations=50, prune=0.0)
    assert vb2.likelihood_bound() >= bound - 1e-8
    # the JAX package reads the port's VB state
    jvb = jcheckpoint.load_vb(tmp_path / "vb.npz", data)
    assert jvb.likelihood_bound() == pytest.approx(bound, rel=1e-10)

    inv = torch.tensor(np.linalg.inv(COVS[1]))

    def target(x):
        d = x - torch.tensor(MEANS[1])
        return -0.5 * d @ inv @ d

    mc = pypmc_tpu_torch.sampler.AdaptiveMarkovChain(target, td.LocalGauss(np.eye(2)),
                                                      MEANS[1].copy(), rng=0)
    mc.run(200)
    mc.adapt()
    checkpoint.save_chain_state(tmp_path / "chain.npz", mc)
    mc2 = pypmc_tpu_torch.sampler.AdaptiveMarkovChain(target, td.LocalGauss(np.eye(2)),
                                                       MEANS[1].copy(), rng=1)
    checkpoint.load_chain_state(tmp_path / "chain.npz", mc2)
    np.testing.assert_array_equal(mc2.current_point, mc.current_point)
    np.testing.assert_allclose(mc2.proposal.sigma, mc.proposal.sigma)
    assert mc2.adapt_count == mc.adapt_count == 2
    assert mc2.run(100) >= 0


def test_evaluate_fn_matches_jax():
    """MixtureDensity.evaluate_fn: per point and batched (transposed), on
    the mixture's device, against the JAX package's log-density."""
    x = np.random.default_rng(1).normal(1, 2, (50, 2))
    for student_t in (False, True):
        make = lambda pkg: (pkg.density.create_t_mixture(MEANS, COVS, [5.0, 7.0], WEIGHTS)
                            if student_t else
                            pkg.density.create_gaussian_mixture(MEANS, COVS, WEIGHTS))
        ref = np.asarray(make(jpt).multi_evaluate(x))
        mix = make(pypmc_tpu_torch)
        batched = mix.evaluate_fn(batched=True)
        np.testing.assert_allclose(batched(torch.tensor(x.T)).numpy(), ref, rtol=1e-12)
        point = mix.evaluate_fn()
        np.testing.assert_allclose([float(point(torch.tensor(v))) for v in x[:5]], ref[:5],
                                   rtol=1e-12)
