"""Large-scale Student-t mixture PMC on the card: the port's counterpart of
``examples/pmc_large_scale.py`` (BASELINE.md acceptance config 5).
10^7 particles per adaptation step, a K=10 Student-t proposal in D=10
against a bimodal Gaussian-mixture target (0.3/0.7), 10 steps, with the
sufficient statistics summed over the ranks of a particle mesh.

One process on the card:

    python examples_torch/pmc_large_scale.py --particles 10000000 --steps 10

Several processes: start one a rank with ``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE`` and ``RANK`` set (``examples_torch/launch_2proc.py`` does);
each then joins the group through
``pypmc_tpu_torch.parallel.distributed_initialize`` over ``--backend``
(default: NCCL on the card, gloo on the CPU; two ranks sharing one card
need gloo).  The working dtype is the port's: float32 on the card, float64
on the CPU.
"""

import argparse
import hashlib
import json
import os
import statistics
import time

import numpy as np
import torch

import pypmc_tpu_torch as pt
from pypmc_tpu_torch.density import core
from pypmc_tpu_torch.ops import kernels
from pypmc_tpu_torch.parallel import distributed_initialize, particle_mesh, pmc_run_sharded


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--particles", type=int, default=10_000_000)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--dim", type=int, default=10)
    ap.add_argument("--components", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None,
                    help="torch.distributed backend when WORLD_SIZE is set")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    with pt.using_device(args.device):
        device = pt.default_device()
        joined = bool(os.environ.get("WORLD_SIZE")) and not torch.distributed.is_initialized()
        if joined:
            # manual multi-process launches (launch_2proc.py, the mpirun -n 2
            # analog) pass the process topology in the environment
            distributed_initialize(**({"backend": args.backend} if args.backend else {}))
        try:
            return run(args, device)
        finally:
            if joined:
                torch.distributed.destroy_process_group()


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args, device):
    K, D = args.components, args.dim
    rng = np.random.default_rng(0)

    # multimodal Gaussian-mixture target: two well-separated modes
    t_means = np.stack([rng.normal(0, 1, D), rng.normal(0, 1, D) + 3.0])
    t_covs = np.array([np.eye(D) * 0.8, np.eye(D) * 1.2])
    # passing the target as MixtureParams lets pmc_run_sharded run the whole
    # step (propose, both evaluations, weights, responsibilities,
    # statistics) as one kernel, fused_is_pmc_step (K-blocked from ~K=200)
    log_target, _ = core.make_mixture(t_means, t_covs, np.array([0.3, 0.7]), device=device)

    # wide Student-t proposal covering both modes
    means = rng.normal(1.5, 3.0, size=(K, D))
    covs = np.array([np.eye(D) * 6.0] * K)
    dofs = np.full((K,), 8.0)
    params, _ = core.make_mixture(means, covs, None, dofs, device=device)

    mesh = particle_mesh()
    n_total = (args.particles // mesh.size) * mesh.size
    print("mesh: %d rank(s) on %s; %d particles per PMC step" % (mesh.size, device, n_total))

    # warm up with the timed call's own step count, then synchronize: the
    # first launches build or load the kernels
    pmc_run_sharded(log_target, params, n_total, args.steps, mesh=mesh, key=0)
    sync(device)

    # a few repetitions with distinct seeds, the median reported; the seeds
    # are the same on every rank, so the adapted mixture is too
    per_step_ms = []
    for rep in range(3):
        sync(device)
        t0 = time.perf_counter()
        params_out, stats = pmc_run_sharded(log_target, params, n_total, args.steps,
                                            mesh=mesh, key=1 + rep)
        sync(device)
        per_step_ms.append((time.perf_counter() - t0) / args.steps * 1e3)
    params = params_out
    dt_ms = statistics.median(per_step_ms)
    s = {f: getattr(stats, f).double().cpu().numpy() for f in stats._fields}

    print("perplexity per step:", np.round(s["perplexity"], 4))
    print("ESS per step:       ", np.round(s["ess"], 4))
    print("step time: %.1f ms (median of %d)  |  throughput: %.1f M samples/s (total)"
          % (dt_ms, len(per_step_ms), n_total / dt_ms / 1e3))

    w = params.weights.double().cpu().numpy()
    mu = params.means.double().cpu().numpy()
    masses = [float(w[np.linalg.norm(mu - t_means[j], axis=1) < 3].sum()) for j in (0, 1)]
    print("live components:", int((w > 0.01).sum()),
          "| weight mass near mode A/B:", np.round(masses, 3))

    # every rank computes the same adapted mixture from the summed
    # statistics (no proposal broadcast); launch_2proc.py compares this line
    h = hashlib.sha256()
    for arr in (params.means, params.cov, params.weights, params.dof):
        h.update(np.ascontiguousarray(arr.cpu().numpy()).tobytes())
    digest = h.hexdigest()[:16]
    print("adapted digest: %s" % digest)
    # the kernels this process launched and the routes the size gate sent
    # past them ("plain:"), since the last reset of the counts
    launches = {n: c for n, c in kernels.launch_counts().items()
                if c and not n.startswith("variant:")}
    print("kernel launches: %s" % json.dumps(launches))
    return {"n_total": n_total, "ranks": mesh.size, "components": K, "step_ms": dt_ms,
            "per_step_ms": per_step_ms, "perplexity": s["perplexity"].tolist(),
            "ess": s["ess"].tolist(), "evidence": s["evidence"].tolist(),
            "live": int((w > 0.01).sum()), "masses": masses, "digest": digest,
            "launches": launches}


if __name__ == "__main__":
    main()
