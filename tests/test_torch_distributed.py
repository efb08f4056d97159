"""The port's multi-rank path: two ranks over gloo on the CPU, the
counterparts of tests/test_distributed.py's two-process scenarios.

One launch of two worker processes (once for the module; each under a
300 s limit, after which both are killed) runs every scenario; each
scenario is its own test, read from the workers' marker lines:

* the PMC update with its statistics all-reduced over the two ranks'
  halves of a float64 particle set, against the JAX package's
  single-process update on all of them (computed here, atol 1e-12);
* an IS + PMC run on the mesh: every rank holds the same adapted mixture
  (equal digests), which is what makes the reference's proposal broadcast
  unnecessary;
* GaussianInference(mesh=) on both E-step routes against one process on
  all the data, with the data padded to an even split;
* a non-divisible particle count, rounded up;
* checkpoints into a shared directory: only rank 0 writes;
* ParallelSampler.gather: both ranks hold the same global arrays;
* integrate(mesh=): the same estimate on both ranks.

The workers import torch and the port only.
"""

import json
import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from pypmc_tpu.density import core as jcore
from pypmc_tpu.mix_adapt.pmc import pmc_update as jax_pmc_update

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import hashlib, json, os, sys
import numpy as np
import torch

torch.set_num_threads(1)
import pypmc_tpu_torch
from pypmc_tpu_torch import checkpoint
from pypmc_tpu_torch.density import core, create_gaussian_mixture, create_t_mixture
from pypmc_tpu_torch.mix_adapt import GaussianInference
from pypmc_tpu_torch.mix_adapt.pmc import pmc_update
from pypmc_tpu_torch.parallel import (ParallelSampler, distributed_initialize,
                                      particle_mesh, pmc_run_sharded, run_is_step_sharded)
from pypmc_tpu_torch.pipeline import integrate

assert "jax" not in sys.modules, "the port imported jax"
pypmc_tpu_torch.set_default_device("cpu")
RANK, SHARED = int(sys.argv[2]), sys.argv[3]
distributed_initialize(sys.argv[1], 2, RANK)   # the CPU's default backend: gloo
assert torch.distributed.get_backend() == "gloo"
mesh = particle_mesh()
assert (mesh.size, mesh.rank, mesh.axis_names) == (2, RANK, ("particles",))


def report(name, ok, extra=None):
    print("CHECK %s %s %s" % (name, "OK" if ok else "MISMATCH", json.dumps(extra)), flush=True)
    return ok


def digest(tag, *tensors):
    h = hashlib.sha256()
    for t in tensors:
        t = torch.as_tensor(t)
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    print("DIGEST %s %s" % (tag, h.hexdigest()), flush=True)


def host(params):
    return {f: getattr(params, f).tolist() for f in ("means", "cov", "weights", "dof")
            if getattr(params, f) is not None}


all_ok = True

# ---- 1. the PMC update: each rank's half, statistics all-reduced ---- #
MEANS = np.array([[1.0, -1.0], [2.0, 3.0]])
COVS = np.array([[[1.3, 0.7], [0.7, 1.5]], [[0.5, 0.0], [0.0, 0.5]]])
n = 400
rng = np.random.default_rng(0)
samples = rng.normal(size=(n, 2))
weights = np.abs(rng.normal(1.0, 0.2, size=n))
lo, hi = RANK * (n // 2), (RANK + 1) * (n // 2)
updates = {}
for label, dofs in (("gauss", None), ("student_t", np.array([5.0, 9.0]))):
    params = core.make_mixture(torch.tensor(MEANS), torch.tensor(COVS),
                               torch.tensor([0.5, 0.5], dtype=torch.float64),
                               None if dofs is None else torch.tensor(dofs))[0]
    res = pmc_update(params, torch.tensor(samples[lo:hi]), torch.tensor(weights[lo:hi]),
                     reduce=mesh.reduce)
    updates[label] = host(res.params)
all_ok &= report("pmc_identity", True, updates)

# ---- 2. IS + PMC on the mesh: the same mixture on every rank ---- #
t_params = core.make_mixture(torch.tensor([[-2.0, 0.0], [2.0, 0.5]], dtype=torch.float64),
                             torch.eye(2, dtype=torch.float64).expand(2, 2, 2) * 0.8,
                             torch.tensor([0.3, 0.7], dtype=torch.float64))[0]
p0 = core.make_mixture(torch.tensor([[-1.0, 0.0], [1.0, 0.0], [0.0, 1.0]], dtype=torch.float64),
                       torch.eye(2, dtype=torch.float64).expand(3, 2, 2) * 3.0)[0]
adapted, stats = pmc_run_sharded(t_params, p0, 4 * 1024, 4, mesh, key=7)
clipped, cstats, xT, w = pmc_run_sharded(t_params, p0, 4 * 1024, 2, mesh, key=8,
                                         weight_clip=True, return_final_samples=True)
digest("is_pmc", adapted.means, adapted.cov, adapted.weights, stats.ess, stats.log_likelihood,
       clipped.means, clipped.cov, cstats.evidence)
all_ok &= report("is_pmc_run",
                 bool(torch.isfinite(stats.ess).all() and torch.isfinite(adapted.means).all()
                      and xT.shape == (2, 2048) and w.shape == (2048,)),
                 {"ess": stats.ess.tolist(), "evidence": stats.evidence.tolist()})

# ---- 3. GaussianInference(mesh=) against one process on all the data ---- #
n_vb = 1201   # odd: the two shards are padded to 601 particles each
data = np.vstack([np.random.default_rng(1).normal(-2, 0.5, size=(600, 2)),
                  np.random.default_rng(2).normal(2, 0.5, size=(n_vb - 600, 2))])
w_vb = np.abs(np.random.default_rng(3).normal(1, 0.2, n_vb))
vb_ok = True
for label, K in (("fused", 2), ("unfused", 70)):
    m_init = np.random.default_rng(4).normal(0, 2, (K, 2))
    plain = GaussianInference(data, components=K, weights=w_vb, nu=np.full(K, 3.0), m=m_init)
    plain.run(20, prune=0.0)
    vb = GaussianInference(data, components=K, weights=w_vb, nu=np.full(K, 3.0), m=m_init,
                           mesh=mesh)
    assert vb._shard_T.shape == (2, 601) and float(vb._shard_w[600:].sum()) == (
        0.0 if RANK else float(vb._shard_w[600]))
    assert vb._fused_eligible() == (None if label == "unfused" else "dense")
    vb.run(20, prune=0.0)
    vb_ok &= (np.allclose(vb.N_comp.numpy(), plain.N_comp.numpy(), rtol=1e-10, atol=1e-10)
              and np.allclose(vb.m.numpy(), plain.m.numpy(), rtol=1e-10, atol=1e-10)
              and np.isclose(vb.likelihood_bound(), plain.likelihood_bound(), rtol=1e-12)
              and vb.r.shape == (n_vb, K)
              and np.allclose(vb.r.numpy(), plain.r.numpy(), atol=1e-10))
    digest("vb_" + label, vb.m, vb.W, vb.alpha, vb.N_comp)
all_ok &= report("vb_sharded", vb_ok)

# ---- 4. a non-divisible particle count is rounded up ---- #
xs, ws, ls = run_is_step_sharded(p0, t_params, 9, 403, mesh)
adapted2, stats2 = pmc_run_sharded(t_params, p0, 403, 1, mesh, key=9)
all_ok &= report("non_divisible", xs.shape == (2, 202) and ws.shape == (202,)
                 and bool(torch.isfinite(adapted2.means).all()))

# ---- 5. checkpoints into a shared directory: rank 0 writes ---- #
gate_path = os.path.join(SHARED, "gate.npz")
checkpoint.atomic_savez(gate_path, marker=np.array([float(RANK)]))
mix_path = os.path.join(SHARED, "adapted.npz")
checkpoint.save_mixture(mix_path, adapted)
torch.distributed.barrier()
with np.load(gate_path) as f:
    writer = int(f["marker"][0])
loaded = checkpoint.load_mixture_params(mix_path, device="cpu")
digest("ckpt", loaded.means, loaded.cov, loaded.weights)
all_ok &= report("ckpt_gate", writer == 0 and checkpoint.is_primary_process() == (RANK == 0)
                 and torch.equal(loaded.means, adapted.means), {"writer": writer})

# ---- 6. ParallelSampler: every rank holds the global runs ---- #
mu, inv = torch.tensor([0.0, 1.0], dtype=torch.float64), torch.tensor(
    np.linalg.inv([[2.0, 0.3], [0.3, 1.0]]))


def log_target(x):
    diff = x - mu
    return -0.5 * diff @ inv @ diff


mix = create_t_mixture(MEANS, COVS, np.array([5.0, 9.0]), np.array([0.5, 0.5]))
ps = ParallelSampler(log_target, mix, mesh=mesh, rng=3, save_target_values=True)
ps.run(100)
ps.run(50, to_host=False)
sw, sw2, n_ev = ps.evidence_stats()
assert ps.gather() == 1
n_hist = ps.samples[:].shape
digest("gather", ps.samples[:], ps.weights[:], ps.target_values[:])
host_w = ps.weights[:][:, 0]
exact_tv = torch.func.vmap(log_target)(torch.tensor(ps.samples[:])).numpy()
all_ok &= report("gather", n_hist == (300, 2) and n_ev == 300
                 and np.isclose(sw, host_w.sum(), rtol=1e-12)
                 and np.isclose(sw2, (host_w ** 2).sum(), rtol=1e-12)
                 and [len(s) for s in ps.samples_list] == [50, 50]
                 and np.allclose(ps.target_values[:][:, 0], exact_tv, atol=1e-9))

# ---- 7. integrate(mesh=): the same estimate on every rank ---- #
target = create_gaussian_mixture(np.stack([np.zeros(2), np.full(2, 3.0)]),
                                 np.array([np.eye(2) * 0.7] * 2), np.array([0.4, 0.6]))
srng = np.random.default_rng(0)
starts = np.vstack([srng.normal(0, 1.5, (6, 2)), srng.normal(3, 1.5, (6, 2))])
r = integrate(target, 2, starts, key=0, mesh=mesh, checkpoint_dir=os.path.join(SHARED, "run"),
              mcmc_steps=200, mcmc_cycles=6, n_is1=1 << 12, n_is2=1 << 13, pmc_steps=3)
digest("integrate", torch.tensor([r.evidence, r.uncertainty, r.ess]), r.weights, r.samples)
sigma = r.uncertainty
all_ok &= report("integrate", abs(r.evidence - 1.0) < 5 * sigma + 1e-3
                 and r.n_samples == (1 << 12) + (1 << 13) and r.samples.shape == (r.n_samples, 2),
                 {"evidence": r.evidence, "uncertainty": sigma, "ess": r.ess})

torch.distributed.destroy_process_group()
print("RESULT", RANK, "OK" if all_ok else "MISMATCH", flush=True)
sys.exit(0 if all_ok else 1)
"""


def _launch(workdir):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    worker = os.path.join(workdir, "worker.py")
    with open(worker, "w") as f:
        f.write(_WORKER)
    shared = os.path.join(workdir, "ckpt")
    os.makedirs(shared)
    env = dict(os.environ, PYTHONPATH=_REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, worker, "127.0.0.1:%d" % port, str(rank), shared],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for rank in range(2)]
    outputs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
            out += "\n(killed at the 300 s limit)"
        outputs.append(out)
    return procs, outputs, shared


@pytest.fixture(scope="module")
def dist_run(tmp_path_factory):
    return _launch(str(tmp_path_factory.mktemp("torch_dist")))


def _check(outputs, name):
    """Both ranks' marker line of scenario ``name``; returns their extras."""
    extras = []
    for rank, out in enumerate(outputs):
        lines = [l for l in out.splitlines() if l.startswith("CHECK %s " % name)]
        assert lines, "rank %d never reported %s:\n%s" % (rank, name, out[-3000:])
        assert lines[0].split()[2] == "OK", "rank %d: %s" % (rank, lines[0])
        extras.append(json.loads(lines[0].split(" ", 3)[3]))
    return extras


def _digests(outputs, tag):
    found = []
    for rank, out in enumerate(outputs):
        lines = [l for l in out.splitlines() if l.startswith("DIGEST %s " % tag)]
        assert lines, "rank %d printed no %s digest" % (rank, tag)
        found.append(lines[0].split()[2])
    return found


def test_two_rank_workers_exit_cleanly(dist_run):
    procs, outputs, _ = dist_run
    for rank, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, "rank %d failed:\n%s" % (rank, out[-3000:])


def test_two_rank_pmc_update_matches_the_jax_package(dist_run):
    """Both ranks' all-reduced update equals the JAX package's
    single-process update on all the particles, in float64."""
    MEANS = np.array([[1.0, -1.0], [2.0, 3.0]])
    COVS = np.array([[[1.3, 0.7], [0.7, 1.5]], [[0.5, 0.0], [0.0, 0.5]]])
    rng = np.random.default_rng(0)
    samples = rng.normal(size=(400, 2))
    weights = np.abs(rng.normal(1.0, 0.2, size=400))
    for extra in _check(dist_run[1], "pmc_identity"):
        for label, dofs in (("gauss", None), ("student_t", np.array([5.0, 9.0]))):
            params, _ = jcore.make_mixture(MEANS, COVS, np.array([0.5, 0.5]), dofs)
            ref = jax_pmc_update(params, jnp.asarray(samples), jnp.asarray(weights)).params
            for f, got in extra[label].items():
                np.testing.assert_allclose(np.asarray(got), np.asarray(getattr(ref, f)),
                                           rtol=0, atol=1e-12, err_msg="%s %s" % (label, f))


def test_two_rank_is_pmc_run(dist_run):
    for extra in _check(dist_run[1], "is_pmc_run"):
        assert extra["ess"][-1] > 0.5


def test_two_rank_vb_sharded(dist_run):
    _check(dist_run[1], "vb_sharded")


def test_two_rank_non_divisible_n(dist_run):
    _check(dist_run[1], "non_divisible")


def test_two_rank_checkpoint_gating(dist_run):
    """Both ranks save to the same paths; only rank 0's file exists, and
    both resume the same state from it."""
    _check(dist_run[1], "ckpt_gate")
    names = sorted(os.listdir(dist_run[2]))
    assert "gate.npz" in names and not any(".tmp." in n for n in names), names
    # integrate(checkpoint_dir=) on the mesh: rank 0's stage files only
    assert sorted(os.listdir(os.path.join(dist_run[2], "run"))) == [
        "mcmc.npz", "refined_mixture.npz", "vb1.npz", "vb1_mixture.npz"]


def test_two_rank_parallel_sampler_gather(dist_run):
    _check(dist_run[1], "gather")


def test_two_rank_integrate(dist_run):
    _check(dist_run[1], "integrate")


@pytest.mark.parametrize("tag", ["is_pmc", "vb_fused", "vb_unfused", "ckpt", "gather",
                                 "integrate"])
def test_ranks_agree_without_broadcast(dist_run, tag):
    """Every rank prints the same digest: the all-reduced statistics give
    every rank the same mixture, so no rank broadcasts one."""
    first, second = _digests(dist_run[1], tag)
    assert first == second
