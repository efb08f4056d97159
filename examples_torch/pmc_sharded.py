"""Particle-mesh parallel PMC on the card: the port's counterpart of
``examples/pmc_sharded.py`` (the TPU-native replacement of the
reference's ``examples/pmc_mpi.py``).  The bimodal-target PMC workload of
``pmc.py`` (10 steps of ~1,000 particles), with the particle axis split
over the ranks of a particle mesh and the sufficient statistics summed by
an all-reduce: no gather to rank 0, no proposal broadcast.

    python examples_torch/pmc_sharded.py

Outside a ``torch.distributed`` group the mesh is this one process.
"""

import argparse

import numpy as np

import pypmc_tpu_torch as pt
from pypmc_tpu_torch.parallel import particle_mesh, pmc_run_sharded

# bimodal Gaussian target (same as pmc.py)
component_weights = np.array([0.3, 0.7])
mean0 = np.array([5.0, 0.01])
covariance0 = np.array([[0.01, 0.003], [0.003, 0.0025]])
mean1 = np.array([-4.0, 1.0])
covariance1 = np.array([[0.1, 0.0], [0.0, 0.02]])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    with pt.using_device(args.device):
        pt.default_device()   # raises without CUDA unless --device asks for the CPU
        return run()


def run():
    target_mixture = pt.density.create_gaussian_mixture(
        [mean0, mean1], [covariance0, covariance1], component_weights)
    # passing the target's stacked MixtureParams (instead of a callable,
    # e.g. ``target_mixture.evaluate_fn()``) lets pmc_run_sharded fuse the
    # whole step into one kernel on the card
    log_target = target_mixture.stacked_params()

    # poor initial proposal: three wide components
    initial_proposal = pt.density.create_gaussian_mixture(
        [np.array([4.0, 0.0]), np.array([-5.0, 0.0]), np.array([0.0, 0.0])],
        [np.eye(2)] * 3)
    params = initial_proposal.stacked_params()

    mesh = particle_mesh()
    n_dev = mesh.size
    n_total = n_dev * (1000 // n_dev + 1) * n_dev  # ~1000 per step, divisible
    print("mesh: %d rank(s); %d particles per PMC step" % (n_dev, n_total))

    params, stats = pmc_run_sharded(log_target, params, n_total=n_total, n_steps=10,
                                    mesh=mesh, key=0)
    perplexity = stats.perplexity.double().cpu().numpy()
    ess = stats.ess.double().cpu().numpy()
    print("perplexity per step:", np.round(perplexity, 3))
    print("ESS per step:       ", np.round(ess, 3))
    print()

    adapted = pt.density.MixtureDensity.from_params(params)
    print("final component weights:", np.round(adapted.weights, 3))
    print("target component weights:", component_weights)
    for k in np.flatnonzero(adapted.weights > 0.05):
        print("component %d mean:" % k, np.round(adapted.components[k].mu, 3))
    means = np.array([c.mu for c in adapted.components])
    masses = [float(adapted.weights[np.linalg.norm(means - m, axis=1) < 3].sum())
              for m in (mean0, mean1)]
    return {"n_total": n_total, "ranks": n_dev, "perplexity": perplexity.tolist(),
            "ess": ess.tolist(), "weights": adapted.weights.tolist(), "masses": masses}


if __name__ == "__main__":
    main()
