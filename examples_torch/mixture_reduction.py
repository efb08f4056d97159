"""Mixture reduction on the card: the port's counterpart of
``examples/mixture_reduction.py`` (the reference's workload).  Compress a
400-component Gaussian mixture with hierarchical clustering (preserves all
10 initial-guess components) and with VBMerge (automatically selects the
number of survivors).  The input mixture is numpy's, from seed 0, so the
result depends on nothing else.

    python examples_torch/mixture_reduction.py
"""

import argparse

import numpy as np
from scipy.stats import chi2

import pypmc_tpu_torch as pt

D = 2          # dimension
K = 400        # input components
W = np.eye(D)  # Wishart mean
nu = 5         # Wishart dof
K_out = 10


def input_mixtures():
    """The 400-component input mixture and the 10-component initial guess."""
    rng = np.random.default_rng(0)

    def wishart_draw():
        chol = np.linalg.cholesky(W)
        tmp = np.zeros((D, D))
        for i in range(D):
            for j in range(i + 1):
                if i == j:
                    tmp[i, j] = np.sqrt(chi2.rvs(nu - (i + 1) + 1, random_state=rng))
                else:
                    tmp[i, j] = rng.normal(0, 1)
        return chol @ tmp @ tmp.T @ chol.T

    covariances = [wishart_draw() for _ in range(K)]
    means = [rng.multivariate_normal(np.zeros(D), sigma) for sigma in covariances]
    weights = np.ones(K)
    input_mixture = pt.density.create_gaussian_mixture(means, covariances, weights)
    initial_guess = pt.density.create_gaussian_mixture(
        means[:K_out], covariances[:K_out], weights[:K_out])
    return input_mixture, initial_guess


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    with pt.using_device(args.device):
        pt.default_device()   # raises without CUDA unless --device asks for the CPU
        return run()


def run():
    input_mixture, initial_guess = input_mixtures()

    # ---- hierarchical clustering: every component preserved ---- #
    h = pt.mix_adapt.Hierarchical(input_mixture, initial_guess)
    steps = h.run()
    print("hierarchical: %s steps, %d components remain" % (steps, len(h.g)))

    # ---- VBMerge: survivors chosen automatically ---- #
    vb = pt.mix_adapt.VBMerge(input_mixture, N=1000, initial_guess=initial_guess)
    print("Start variational Bayes:")
    converged = vb.run()
    vb_mix = vb.make_mixture()
    print("VBMerge: %d components remain" % len(vb_mix))

    try:
        import matplotlib.pyplot as plt

        plt.figure(figsize=(15, 5))
        for idx, (mix, title) in enumerate(
                [(input_mixture, "input (400)"), (h.g, "hierarchical"), (vb_mix, "VBMerge")]):
            plt.subplot(1, 3, idx + 1)
            plt.title(title)
            pt.tools.plot_mixture(mix)
            plt.xlim(-5, 5)
            plt.ylim(-5, 5)
        plt.savefig("mixture_reduction_example.png", dpi=100)
        plt.close("all")
        print("wrote mixture_reduction_example.png")
    except ImportError:
        print('For plotting "matplotlib" needs to be installed')
    return {"hierarchical_steps": steps, "hierarchical": h.g, "vb_converged": converged,
            "vb_mixture": vb_mix, "vb_bound": vb.likelihood_bound()}


if __name__ == "__main__":
    main()
