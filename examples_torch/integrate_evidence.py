"""One-call evidence estimation with ``pypmc_tpu_torch.pipeline.integrate``
on the card: the port's counterpart of ``examples/integrate_evidence.py``.

Estimates the evidence (analytically 1) of a bimodal 20-dimensional
Gaussian mixture -- the regime of the reference's headline claim (<=1%
error in up to 30-40 dimensions) -- with the full adaptive pipeline in a
single call: adaptive-MCMC chain pool, Gelman-Rubin grouping, variational
Bayes, inflated first IS run, weighted-VB and Student-t-PMC refinement,
final IS run, deterministic-mixture combination.

    python examples_torch/integrate_evidence.py

Pass ``--dim 40`` for the top of the claimed range, or a smaller
``--is-samples`` for a quicker run.  Add ``mesh=`` in the call below to run
the same pipeline over a particle mesh.
"""

import argparse

import numpy as np

import pypmc_tpu_torch as pt


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dim", type=int, default=20)
    ap.add_argument("--chains", type=int, default=16)
    ap.add_argument("--is-samples", type=int, default=1 << 18)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    with pt.using_device(args.device):
        pt.default_device()   # raises without CUDA unless --device asks for the CPU
        return run(args.dim, args.chains, args.is_samples)


def run(dim, chains, is_samples):
    # the target: two well-separated anisotropic Gaussian modes (0.35/0.65)
    rng = np.random.default_rng(7)
    direction = rng.normal(size=dim)
    direction /= np.linalg.norm(direction)
    means = np.stack([np.zeros(dim), 6.0 * direction])
    covs = []
    for _ in range(2):
        a = rng.normal(0, 0.15 / np.sqrt(dim), size=(dim, dim))
        covs.append(np.eye(dim) * rng.uniform(0.5, 1.0) + a @ a.T)
    target = pt.density.create_gaussian_mixture(means, np.array(covs), np.array([0.35, 0.65]))

    # chain starts: overdispersed draws around the modes (in a real
    # application: prior draws covering the region of interest)
    which = rng.integers(0, 2, chains)
    starts = np.stack([rng.multivariate_normal(means[k], 4.0 * np.array(covs)[k])
                       for k in which])

    result = pt.pipeline.integrate(
        target, dim, starts, key=2024, mcmc_steps=300, mcmc_cycles=12,
        n_is1=is_samples // 4, n_is2=is_samples, verbose=True)

    print("analytical evidence = 1")
    print("estimated  evidence = %.5f +- %.5f" % (result.evidence, result.uncertainty))
    print("perplexity %.3f   ESS %.3f   final K = %d   total %.1f s"
          % (result.perplexity, result.ess, len(result.proposal), result.details["total_s"]))
    assert abs(result.evidence - 1.0) < 0.01, "outside the 1% claim!"
    return {"dim": dim, "evidence": result.evidence, "uncertainty": result.uncertainty,
            "perplexity": result.perplexity, "ess": result.ess, "K": len(result.proposal),
            "total_s": result.details["total_s"]}


if __name__ == "__main__":
    main()
