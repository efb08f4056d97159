"""pypmc_tpu_torch.parallel in one process, against pypmc_tpu.parallel on
its 8-device CPU mesh: the counterparts of tests/test_parallel.py's
one-device cases, with the port's one-rank particle mesh.

Deterministic functions take the same numpy inputs (seeded) in both
packages and agree in float64 to 1e-10: the PMC update and log-likelihood
with their sums through the mesh (the JAX side psum'ed over its 8 shards),
and GaussianInference(mesh=) on both E-step routes (the JAX side through
its Pallas kernel in interpret mode, in float32, at that test's
tolerances; and through its XLA path in float64).  A one-rank mesh gives
what no mesh gives, bit for bit.  Random paths are held in distribution:
moments, component masses, evidence.  The multi-rank sums are
tests/test_torch_distributed.py's."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import pypmc_tpu.density.core as jcore
import pypmc_tpu.mix_adapt.pmc as jpmc
import pypmc_tpu.mix_adapt.variational as jvb
import pypmc_tpu.parallel as jparallel
import pypmc_tpu_torch
from pypmc_tpu_torch.density import core, create_gaussian_mixture, create_t_mixture
from pypmc_tpu_torch.mix_adapt import variational as tvb
from pypmc_tpu_torch.mix_adapt.pmc import (pmc_log_likelihood, pmc_step_mixture_target,
                                           pmc_update)
from pypmc_tpu_torch.parallel import (ParallelSampler, particle_mesh, pmc_run_sharded,
                                      run_is_step_sharded)
from pypmc_tpu_torch.parallel.mesh import ParticleMesh
from pypmc_tpu_torch.parallel.sampler import clear_step_cache
from pypmc_tpu_torch.sampler import batched_target

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port runs on the card unless the CPU is asked for: ask for it."""
    with pypmc_tpu_torch.using_device("cpu"):
        yield


MEANS = np.array([[1.0, -1.0], [2.0, 3.0], [-3.0, 0.5]])
COVS = np.array([[[1.3, 0.7], [0.7, 1.5]], [[0.5, 0.0], [0.0, 0.5]],
                 [[2.0, -0.4], [-0.4, 1.0]]])
WEIGHTS = np.array([0.5, 0.3, 0.2])
DOFS = np.array([5.0, 9.0, 30.0])
TARGET_MU = np.array([0.0, 1.0])
TARGET_INV = np.linalg.inv(np.array([[2.0, 0.3], [0.3, 1.0]]))
MU_T, INV_T = torch.tensor(TARGET_MU), torch.tensor(TARGET_INV)


def log_target(x):
    """tests/test_parallel.py's per-point target (ParallelSampler maps it)."""
    diff = x - MU_T
    return -0.5 * diff @ INV_T @ diff


@batched_target
def block_target(x):
    """The same target on a row-major (N, D) block, marked batched."""
    diff = x - MU_T
    return -0.5 * torch.einsum("ni,ij,nj->n", diff, INV_T, diff)


def params(student_t=False):
    """The same mixture in both packages."""
    jp, _ = jcore.make_mixture(MEANS, COVS, WEIGHTS, DOFS if student_t else None)
    return jp, core.params_from_numpy(jp)


def assert_params_equal(a, b, fields=("means", "cov", "weights", "dof")):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert torch.equal(x, y), f


def assert_close_to_jax(port, ref, atol=1e-10, fields=("means", "cov", "weights")):
    for f in fields:
        np.testing.assert_allclose(getattr(port, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=0, atol=atol, err_msg=f)


def jax_sharded_update(jp, samples, weights, **kw):
    mesh = jparallel.particle_mesh()

    @partial(jax.shard_map, mesh=mesh, in_specs=(P(), P("particles"), P("particles")),
             out_specs=P(), check_vma=False)
    def sharded(p, s, w):
        return jpmc.pmc_update(p, s, w, axis_name="particles", **kw).params

    return jax.jit(sharded)(jp, jnp.asarray(samples), jnp.asarray(weights))


def test_one_rank_mesh():
    mesh = particle_mesh()
    assert (mesh.size, mesh.rank, mesh.group, mesh.axis_names) == (1, 0, None, ("particles",))
    assert mesh.device == torch.device("cpu")
    x = torch.arange(6.0).reshape(2, 3)
    assert mesh.reduce(x) is x and torch.equal(mesh.all_gather(x), x)
    assert particle_mesh(["cpu"]).device == torch.device("cpu")
    with pytest.raises(ValueError):
        particle_mesh(["cpu", "cpu"])
    assert clear_step_cache() is None


class TestShardedInvariance:
    """The update with its sums through the mesh equals the JAX package's
    psum'ed update over 8 shards of the same particles."""

    @pytest.mark.parametrize("student_t", [False, True])
    def test_pmc_update_sharded_equals_serial(self, student_t):
        mesh = particle_mesh()
        rng = np.random.default_rng(0)
        samples = rng.normal(size=(400, 2))
        weights = np.abs(rng.normal(1.0, 0.2, size=400))
        jp, tp = params(student_t)
        s, w = torch.tensor(samples), torch.tensor(weights)
        sharded = pmc_update(tp, s, w, reduce=mesh.reduce).params
        assert_params_equal(sharded, pmc_update(tp, s, w).params)
        ref = jax_sharded_update(jp, samples, weights)
        assert_close_to_jax(sharded, ref, fields=("means", "cov", "weights")
                            + (("dof",) if student_t else ()))

    def test_log_likelihood_sharded_equals_serial(self):
        mesh = particle_mesh()
        samples = np.random.default_rng(1).normal(size=(200, 2))
        jp, tp = params()
        got = pmc_log_likelihood(tp, torch.tensor(samples), reduce=mesh.reduce)

        @partial(jax.shard_map, mesh=jparallel.particle_mesh(),
                 in_specs=(P(), P("particles")), out_specs=P())
        def sharded(p, s):
            return jpmc.pmc_log_likelihood(p, s, axis_name="particles")

        ref = float(jax.jit(sharded)(jp, jnp.asarray(samples)))
        assert float(got) == float(pmc_log_likelihood(tp, torch.tensor(samples)))
        assert abs(float(got) - ref) < 1e-10


class TestShardedSampling:
    def test_run_is_step_sharded_shapes_and_weights(self):
        _, tp = params()
        samples_T, weights, latent = run_is_step_sharded(
            tp, block_target, 0, 800, particle_mesh())
        assert samples_T.shape == (2, 800) and weights.shape == (800,)
        assert latent.shape == (800,)
        log_q = core.mixture_logpdf_T(tp, samples_T)
        np.testing.assert_allclose(weights.numpy(),
                                   torch.exp(block_target(samples_T.T) - log_q).numpy(),
                                   rtol=1e-12)
        # a one-rank mesh draws what no mesh draws
        for x, y in zip((samples_T, weights, latent),
                        run_is_step_sharded(tp, block_target, 0, 800)):
            assert torch.equal(x, y)

    def test_ranks_produce_distinct_samples(self):
        """Each rank folds its rank into the seed words: rank 0 draws what
        one process draws, the others streams of their own (a mesh object
        of 4 ranks stands in for each rank; drawing needs no sums)."""
        _, tp = params()
        shards = [run_is_step_sharded(tp, block_target, 0, 4 * 100,
                                      ParticleMesh(4, r, None, "cpu"))[0] for r in range(4)]
        assert all(s.shape == (2, 100) for s in shards)
        assert torch.equal(shards[0], run_is_step_sharded(tp, block_target, 0, 100)[0])
        for i in range(3):
            assert not torch.allclose(shards[i], shards[i + 1])


class TestPMCRunSharded:
    @pytest.mark.parametrize("student_t", [False, True])
    def test_full_pmc_loop_adapts_to_target(self, student_t):
        means0 = np.array([[-2.0, 0.0], [2.0, 2.0]])
        p0 = core.make_mixture(torch.tensor(means0),
                               torch.tensor(np.array([np.eye(2) * 4.0] * 2)), None,
                               torch.tensor([10.0, 10.0]) if student_t else None)[0]
        out, stats = pmc_run_sharded(block_target, p0, n_total=8 * 500, n_steps=8,
                                     mesh=particle_mesh(), key=1)
        perp = stats.perplexity.numpy()
        assert perp[-1] > 0.8 and perp[-1] > perp[0]
        est = (out.weights[:, None] * out.means).sum(0).numpy()
        np.testing.assert_allclose(est, TARGET_MU, atol=0.3)
        ref = pmc_run_sharded(block_target, p0, 8 * 500, 8, key=1)
        assert_params_equal(out, ref[0])

    def test_stats_fields(self):
        _, tp = params()
        _, stats = pmc_run_sharded(block_target, tp, n_total=8 * 100, n_steps=3,
                                   mesh=particle_mesh(), key=5)
        assert stats.perplexity.shape == (3,) and stats.ess.shape == (3,)
        assert (stats.ess > 0).all() and torch.isfinite(stats.log_likelihood).all()


class TestParallelSampler:
    def test_run_and_history(self):
        mix = create_t_mixture(MEANS, COVS, DOFS, WEIGHTS)
        ps = ParallelSampler(log_target, mix, rng=3)
        assert ps.n_devices == 1 and ps.mesh.size == 1
        ps.run(100)
        assert ps.samples[:].shape == (100, 2)
        assert len(ps.samples_list) == 1 and len(ps.samples_list[0]) == 100
        ps.run(50)
        assert ps.samples[:].shape == (150, 2)
        ps.clear()
        assert len(ps.samples) == 0

    def test_device_resident_mode(self):
        """run(to_host=False) keeps the run on the device: the Histories
        stay empty, evidence_stats sums there, and gather() then gives
        exactly what host runs give."""
        mix = create_t_mixture(MEANS, COVS, DOFS, WEIGHTS)
        ps = ParallelSampler(log_target, mix, rng=3, save_target_values=True)
        ps.run(100, to_host=False)
        ps.run(50, to_host=False)
        assert len(ps.samples) == 0 and len(ps.weights) == 0
        assert len(ps.device_runs) == 2
        sT, w = ps.device_runs[0]
        assert isinstance(sT, torch.Tensor) and sT.shape == (2, 100)
        sum_w, sum_w2, n = ps.evidence_stats()
        assert n == 150
        assert np.isclose(sum_w, float(w.sum()) + float(ps.device_runs[1][1].sum()))
        assert ps.gather() == 2
        assert ps.samples[:].shape == (150, 2) and len(ps.device_runs) == 0
        ps2 = ParallelSampler(log_target, mix, rng=3, save_target_values=True)
        ps2.run(100)
        ps2.run(50)
        np.testing.assert_array_equal(ps.samples[:], ps2.samples[:])
        np.testing.assert_array_equal(ps.weights[:], ps2.weights[:])
        s1, w1, n1 = ps.evidence_stats()
        s2, w2, n2 = ps2.evidence_stats()
        assert n1 == n2 and np.isclose(s1, s2) and np.isclose(w1, w2)
        # target values: log w + log q of the drawing proposal, log P itself
        exact = torch.func.vmap(log_target)(torch.tensor(ps.samples[:])).numpy()
        np.testing.assert_allclose(ps.target_values[:][:, 0], exact, atol=1e-9)

    def test_target_values_where_a_weight_underflowed(self):
        """A weight that underflowed to 0 loses its log P; gather
        evaluates the target there, with the proposal that drew the run
        even if the proposal was replaced first."""
        mix = create_gaussian_mixture([TARGET_MU], [np.eye(2)])

        @batched_target
        def spiky(x):
            lp = block_target(x)
            return torch.where(x[:, 0] > 0.5, lp - 1e4, lp)

        ps = ParallelSampler(spiky, mix, rng=1, save_target_values=True)
        ps.run(200, to_host=False)
        ps.proposal = create_gaussian_mixture([np.zeros(2)], [np.eye(2) * 9.0])
        ps.gather()
        w = ps.weights[:][:, 0]
        assert (w == 0).any() and (w > 0).any()
        exact = spiky(torch.tensor(ps.samples[:])).numpy()
        np.testing.assert_allclose(ps.target_values[:][:, 0], exact, rtol=1e-12)

    def test_moment_recovery(self):
        prop = create_gaussian_mixture([TARGET_MU], [np.eye(2) * 3.0])
        ps = ParallelSampler(log_target, prop, rng=8)
        ps.run(20000)
        samples, w = ps.samples[:], ps.weights[:][:, 0]
        mean = (w[:, None] * samples).sum(axis=0) / w.sum()
        np.testing.assert_allclose(mean, TARGET_MU, atol=0.05)


def vb_data(n=1600, d=3, seed=5):
    rng = np.random.default_rng(seed)
    return np.vstack([rng.normal(-2, 0.5, size=(n // 2, d)),
                      rng.normal(2, 0.5, size=(n - n // 2, d))])


class TestShardedVB:
    @pytest.mark.parametrize("K", [4, 70])   # the one-pass E-step; the unfused one
    def test_vb_sharded_data_matches_unsharded(self, K):
        """GaussianInference(mesh=) equals the port without a mesh bit for
        bit, and the JAX package's (XLA E-step, float64) to 1e-10 (1040
        points: the one-pass E-step runs from 1024)."""
        rng = np.random.default_rng(0)
        data = np.vstack([rng.normal(0, 1, (520, 2)), rng.normal(5, 1, (520, 2))])
        w = np.abs(rng.normal(1, 0.2, size=1040))
        m = rng.normal(2.5, 2.0, size=(K, 2))
        plain = tvb.GaussianInference(data, components=K, weights=w, m=m)
        plain.run(iterations=10, prune=0.0)
        sharded = tvb.GaussianInference(data, components=K, weights=w, m=m,
                                        mesh=particle_mesh())
        assert sharded._fused_eligible() == ("dense" if K == 4 else None)
        sharded.run(iterations=10, prune=0.0)
        assert sharded.likelihood_bound() == plain.likelihood_bound()
        for f in ("m", "W", "N_comp", "S", "r"):
            assert torch.equal(getattr(sharded, f), getattr(plain, f)), f
        ref = jvb.GaussianInference(data, components=K, weights=w, m=m)
        ref.run(iterations=10, prune=0.0)
        assert abs(sharded.likelihood_bound() - ref.likelihood_bound()) < 1e-10 * abs(
            ref.likelihood_bound())
        np.testing.assert_allclose(sharded.m.numpy(), np.asarray(ref.m), rtol=0, atol=1e-10)
        np.testing.assert_allclose(sharded.N_comp.numpy(), np.asarray(ref.N_comp), rtol=1e-10,
                                   atol=1e-10)

    def test_shards_are_padded_with_zero_weight(self):
        """Each rank keeps its contiguous 1/size slice; the last slice is
        padded with zero-weight copies of the first data point (mesh
        objects of 3 ranks stand in for each rank)."""
        data = vb_data(n=100, d=2)
        shards = [tvb.GaussianInference(data, components=2, mesh=ParticleMesh(3, r, None, "cpu"))
                  for r in range(3)]
        assert [s._shard_T.shape for s in shards] == [(2, 34)] * 3
        joined = torch.cat([s._shard_T for s in shards], dim=1)
        assert torch.equal(joined[:, :100], torch.tensor(data.T))
        assert torch.equal(joined[:, 100:], torch.tensor(data[:1].T).expand(2, 2))
        w = torch.cat([s._shard_w for s in shards])
        assert torch.equal(w, torch.cat([torch.ones(100, dtype=torch.float64),
                                         torch.zeros(2, dtype=torch.float64)]))


class TestScanSteps:
    def test_scan_steps_adapts_like_loop(self):
        p0 = core.make_mixture(torch.tensor([[-2.0, 0.0], [2.0, 2.0]]),
                               torch.tensor(np.array([np.eye(2) * 4.0] * 2)))[0]
        p_scan, stats = pmc_run_sharded(block_target, p0, n_total=8 * 400, n_steps=6,
                                        mesh=particle_mesh(), key=3, scan_steps=True)
        perp = stats.perplexity.numpy()
        assert stats.perplexity.shape == (6,) and np.isfinite(perp).all()
        assert perp[-1] > perp[0]
        est = (p_scan.weights[:, None] * p_scan.means).sum(0).numpy()
        np.testing.assert_allclose(est, TARGET_MU, atol=0.3)

    @pytest.mark.parametrize("n_steps", [3, 7])
    def test_scan_steps_on_a_one_rank_mesh_equal_the_loop(self, monkeypatch, n_steps):
        """scan_steps=True on a one-rank mesh, in chunks of 3 steps, equals
        the loop without a mesh bit for bit, with a batched callable target
        and with a mixture target (its statistics summed by the mesh's
        reduce)."""
        from pypmc_tpu_torch.sampler import _scan

        monkeypatch.setattr(_scan, "CHUNK", 3)
        p0 = core.make_mixture(torch.tensor([[-2.0, 0.0], [2.0, 2.0]], dtype=torch.float64),
                               torch.tensor(np.array([np.eye(2) * 4.0] * 2)))[0]
        mix = core.make_mixture(torch.tensor(TARGET_MU[None], dtype=torch.float64),
                                torch.tensor(np.eye(2)[None]))[0]
        for target in (block_target, mix):
            loop = pmc_run_sharded(target, p0, 1200, n_steps, key=3)
            scan = pmc_run_sharded(target, p0, 1200, n_steps, mesh=particle_mesh(), key=3,
                                   scan_steps=True)
            for f in ("means", "cov", "weights"):
                assert torch.equal(getattr(loop[0], f), getattr(scan[0], f))
            for x, y in zip(loop[1], scan[1]):
                assert torch.equal(x, y)
        assert clear_step_cache() is None


class TestMixtureTarget:
    """A MixtureParams target runs the one-kernel step (its plain version
    here); a callable the draw and the update.  Both draw the same stream,
    so the runs agree."""

    T_MEANS = np.array([[0.0, 1.0], [2.0, -1.0]])
    T_COVS = np.array([np.eye(2) * 1.5, np.eye(2) * 0.7])

    def targets(self, shift=0.0):
        tt = core.make_mixture(torch.tensor(self.T_MEANS + shift), torch.tensor(self.T_COVS),
                               torch.tensor([0.4, 0.6], dtype=torch.float64))[0]
        return tt, batched_target(lambda xT: core.mixture_logpdf_T(tt, xT), transposed=True)

    @pytest.mark.parametrize("student_t", [False, True])
    def test_mixture_target_equals_callable_target(self, student_t):
        tt, tcall = self.targets()
        _, tp = params(student_t)
        mesh = particle_mesh()
        p_mix, s_mix = pmc_run_sharded(tt, tp, 8 * 300, 3, mesh, key=11)
        p_call, s_call = pmc_run_sharded(tcall, tp, 8 * 300, 3, mesh, key=11)
        np.testing.assert_allclose(p_mix.means.numpy(), p_call.means.numpy(), rtol=1e-6,
                                   atol=1e-9)
        np.testing.assert_allclose(p_mix.weights.numpy(), p_call.weights.numpy(), rtol=1e-6,
                                   atol=1e-12)
        for f in s_mix._fields:
            np.testing.assert_allclose(getattr(s_mix, f).numpy(), getattr(s_call, f).numpy(),
                                       rtol=1e-5, err_msg=f)

    def test_mixture_target_is_an_argument(self):
        """Two target mixtures give two results (the JAX package's guard
        against a compiled step that baked its target in)."""
        _, tp = params()
        p1, _ = pmc_run_sharded(self.targets()[0], tp, 8 * 200, 2, particle_mesh(), key=5)
        p2, _ = pmc_run_sharded(self.targets(2.5)[0], tp, 8 * 200, 2, particle_mesh(), key=5)
        assert not torch.allclose(p1.means, p2.means, atol=0.1)

    def test_step_mixture_target_matches_manual(self):
        """pmc_step_mixture_target with the mesh's sums equals the draw and
        the update composed by hand, with the same seed words."""
        tt, _ = self.targets()
        _, tp = params(True)
        result, samples_T, w, latent, sw = pmc_step_mixture_target(
            tp, tt, 7, 1500, reduce=particle_mesh().reduce)
        s2, l2, logq, logp = core.propose_logq_T(tp, 7, 1500, tt)
        w2 = torch.exp(logp - logq)
        ref = pmc_update(tp, s2, w2, transposed=True, dof_solver_steps=100)
        assert torch.equal(samples_T, s2) and torch.equal(latent, l2)
        for f in ("means", "cov", "dof"):
            np.testing.assert_allclose(getattr(result.params, f).numpy(),
                                       getattr(ref.params, f).numpy(), rtol=1e-6)
        np.testing.assert_allclose(sw[:2].numpy(), [float(w2.sum()), float((w2 * w2).sum())],
                                   rtol=1e-10)


class TestShardedFusedVB:
    def test_sharded_fused_estep_matches_plain(self, monkeypatch):
        """The one-pass E-step with its statistics through the mesh against
        the JAX package's E-step kernel under shard_map (Pallas interpret
        mode, float32 data, that test's tolerances) and its XLA E-step in
        float64 (1e-10)."""
        from pypmc_tpu.ops import pallas_kernels as pk

        data = vb_data()
        nu = np.full(3, 4.0)
        sharded = tvb.GaussianInference(data, components=3, nu=nu, mesh=particle_mesh())
        assert sharded._fused_eligible() == "dense" and sharded._e.r is None
        sharded.run(30, prune=0.0)
        plain64 = jvb.GaussianInference(data, components=3, nu=nu)
        plain64.run(30, prune=0.0)
        np.testing.assert_allclose(sharded.N_comp.numpy(), np.asarray(plain64.N_comp),
                                   rtol=1e-10)
        np.testing.assert_allclose(sharded.m.numpy(), np.asarray(plain64.m), rtol=0,
                                   atol=1e-10)

        monkeypatch.setattr(jcore, "use_pallas", lambda arr, *a, **k: True)
        monkeypatch.setattr(pk, "INTERPRET", True)
        pallas = jvb.GaussianInference(data.astype(np.float32), components=3, nu=nu,
                                       mesh=jparallel.particle_mesh())
        assert pallas._fused_eligible()
        pallas.run(30, prune=0.0)
        np.testing.assert_allclose(sharded.N_comp.numpy(), np.asarray(pallas.N_comp),
                                   rtol=5e-3, atol=5e-2)
        np.testing.assert_allclose(sharded.m.numpy(), np.asarray(pallas.m), rtol=5e-3,
                                   atol=5e-3)
        assert np.isclose(sharded.likelihood_bound(), pallas.likelihood_bound(), rtol=1e-4)


class TestShardedFusedPMC:
    @pytest.mark.parametrize("K,D,fused", [(3, 2, "dense"), (80, 2, "blocked")])
    def test_fused_sharded_equals_serial(self, K, D, fused):
        """The one-pass statistics (the plain versions of fused_pmc_stats
        and fused_pmc_stats_blocked) with their sums through the mesh
        against the JAX package's unfused update, float64."""
        rng = np.random.default_rng(11)
        means = rng.normal(0, 3, size=(K, D))
        covs = np.array([np.eye(D) * 1.5] * K)
        jp, _ = jcore.make_mixture(means, covs)
        tp = core.params_from_numpy(jp)
        samples = rng.normal(0, 3, size=(8 * 1024, D))
        weights = np.abs(rng.normal(1, 0.2, size=8 * 1024))
        got = pmc_update(tp, torch.tensor(samples), torch.tensor(weights), fused=fused,
                         reduce=particle_mesh().reduce).params
        ref = jpmc.pmc_update(jp, jnp.asarray(samples), jnp.asarray(weights)).params
        assert_close_to_jax(got, ref)


class TestNonDivisibleN:
    def test_run_is_step_rounds_up(self):
        """Each rank draws ceil(n_total / size) (a mesh object of 8 ranks
        stands in for rank 3; drawing needs no sums)."""
        _, tp = params()
        samples_T, weights, latent = run_is_step_sharded(
            tp, block_target, 0, 8 * 10 + 3, ParticleMesh(8, 3, None, "cpu"))
        assert samples_T.shape == (2, 11) and weights.shape == (11,)
        assert torch.isfinite(weights).all()

    def test_pmc_run_sharded_rounds_up(self):
        _, tp = params()
        out, stats = pmc_run_sharded(block_target, tp, 8 * 64 + 5, 2, particle_mesh(), key=1)
        assert torch.isfinite(stats.ess).all() and torch.isfinite(out.means).all()

    def test_pmc_run_sharded_non_rb(self):
        """rb=False: the latent indices reach the update (one-hot
        responsibilities), and the run still adapts."""
        _, tp = params()
        out, stats = pmc_run_sharded(block_target, tp, 8 * 256, 3, particle_mesh(), key=2,
                                     rb=False)
        assert torch.isfinite(stats.ess).all() and torch.isfinite(out.means).all()
        assert (out.weights >= 0).all()
        assert float(stats.ess[-1]) > float(stats.ess[0]) - 0.05

    def test_vb_mesh_pads_with_zero_weight(self):
        """N not divisible by the JAX package's 8 devices: its padded
        sharded fit (XLA path, float64) equals the port's, whose padding
        the two-rank tests exercise."""
        data = vb_data(n=8 * 150 + 7, d=2, seed=9)
        nu = np.full(2, 3.0)
        ref = jvb.GaussianInference(data, components=2, nu=nu, mesh=jparallel.particle_mesh())
        assert ref._w_fused.shape[0] == 8 * 151
        ref.run(20, prune=0.0)
        got = tvb.GaussianInference(data, components=2, nu=nu, mesh=particle_mesh())
        got.run(20, prune=0.0)
        np.testing.assert_allclose(got.N_comp.numpy(), np.asarray(ref.N_comp), rtol=1e-10)
        assert abs(got.likelihood_bound() - ref.likelihood_bound()) < 1e-10 * abs(
            ref.likelihood_bound())
