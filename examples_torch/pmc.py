"""Importance sampling with PMC proposal adaptation on the card: the
port's counterpart of ``examples/pmc.py`` (the reference's flagship
workload).  A bimodal 2-D Gaussian target with component weights 0.3/0.7
is recovered by ten 1000-sample PMC steps (``ImportanceSampler`` and the
host PMC update ``mix_adapt.gaussian_pmc``) starting from a deliberately
poor three-component proposal.

    python examples_torch/pmc.py
"""

import argparse

import numpy as np

import pypmc_tpu_torch as pt

# ---- the target: a bimodal Gaussian, log density ---- #
component_weights = np.array([0.3, 0.7])

mean0 = np.array([5.0, 0.01])
covariance0 = np.array([[0.01, 0.003], [0.003, 0.0025]])

mean1 = np.array([-4.0, 1.0])
covariance1 = np.array([[0.1, 0.0], [0.0, 0.02]])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--samples", type=int, default=10**3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    with pt.using_device(args.device):
        pt.default_device()   # raises without CUDA unless --device asks for the CPU
        return run(args.steps, args.samples)


def run(steps, n):
    target_mixture = pt.density.create_gaussian_mixture(
        [mean0, mean1], [covariance0, covariance1], component_weights)
    log_target = target_mixture.evaluate_fn()  # a per-point snapshot on the device

    # ---- a deliberately poor initial proposal ---- #
    initial_proposal = pt.density.create_gaussian_mixture(
        [np.array([4.0, 0.0]), np.array([-5.0, 0.0]), np.array([0.0, 0.0])],
        [np.eye(2)] * 3)

    sampler = pt.sampler.ImportanceSampler(log_target, initial_proposal, rng=42)

    # draw steps x n samples, adapting the proposal with PMC after each step
    for i in range(steps):
        print("\rstep", i, "...")
        latent = sampler.run(n, trace_sort=True)
        samples = sampler.samples[-1]
        weights = sampler.weights[-1][:, 0]
        pt.mix_adapt.gaussian_pmc(samples, sampler.proposal, weights, latent, mincount=20,
                                  rb=True, copy=False)

    print("\rsampling finished")
    print("-----------------")
    print()
    print("initial component weights:", initial_proposal.weights)
    print("final   component weights:", sampler.proposal.weights)
    print("target  component weights:", component_weights)
    print()
    for k, m in enumerate([mean0, mean1, None]):
        print("initial mean of component %i:" % k, initial_proposal.components[k].mu)
        print("final   mean of component %i:" % k, sampler.proposal.components[k].mu)
        print("target  mean of component %i:" % k, m)
        print()
    for k, c in enumerate([covariance0, covariance1, None]):
        print("final covariance of component %i:\n" % k, sampler.proposal.components[k].sigma)
        print("target covariance of component %i:\n" % k, c)
        print()

    try:
        import matplotlib.pyplot as plt

        plt.figure()
        plt.hist2d(sampler.samples[:][:, 0], sampler.samples[:][:, 1],
                   weights=sampler.weights[:][:, 0], bins=100, cmap="gray_r")
        pt.tools.plot_mixture(sampler.proposal, cmap="jet")
        plt.savefig("pmc_example.png", dpi=100)
        plt.close("all")
        print("wrote pmc_example.png")
    except ImportError:
        print('For plotting "matplotlib" needs to be installed')
    return {"weights": np.asarray(sampler.proposal.weights).tolist(),
            "means": [c.mu.tolist() for c in sampler.proposal.components],
            "samples": len(sampler.samples[:])}


if __name__ == "__main__":
    main()
