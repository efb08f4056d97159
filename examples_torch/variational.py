"""Fit a Gaussian mixture to data with variational Bayes on the card: the
port's counterpart of ``examples/variational.py`` (the reference's
workload).  Draw 500 samples from a bimodal Gaussian mixture, fit with K=20
maximum components, expect two survivors.

    python examples_torch/variational.py

:func:`fit` is the VB part alone, for a fit of given data.
"""

import argparse

import numpy as np

import pypmc_tpu_torch as pt

# ---- 1. define a Gaussian mixture ---- #
component_weights = np.array([0.3, 0.7])
mean0 = np.array([5.0, 0.01])
covariance0 = np.array([[0.01, 0.003], [0.003, 0.0025]])
mean1 = np.array([-4.0, 1.0])
covariance1 = np.array([[0.1, 0.0], [0.0, 0.02]])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--samples", type=int, default=500)
    ap.add_argument("--components", type=int, default=20)
    ap.add_argument("--iterations", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    with pt.using_device(args.device):
        pt.default_device()   # raises without CUDA unless --device asks for the CPU
        return run(args.samples, args.components, args.iterations)


def fit(data, K=20, iterations=100):
    """``GaussianInference(data, K).run(iterations)``; returns the fit and
    the iteration it converged at (None if it did not)."""
    vb = pt.mix_adapt.GaussianInference(data, K)
    return vb, vb.run(iterations)


def run(n, K, iterations):
    target_mix = pt.density.create_gaussian_mixture(
        [mean0, mean1], [covariance0, covariance1], component_weights)

    # ---- 2. generate demo data ---- #
    data = target_mix.propose(n, rng=1)

    # ---- 3. adapt a Gaussian mixture with VB ---- #
    vb, converged = fit(data, K, iterations)
    print("-----------------------------")

    fit_mixture = vb.make_mixture()

    # ---- 4. print results ---- #
    if converged is None:
        print("\nThe adaptation did not converge.\n")
    else:
        print("\nConverged after %i iterations.\n" % converged)

    print("final  component weights: " + str(fit_mixture.weights))
    print("target component weights: " + str(target_mix.weights))
    for k, c in enumerate(fit_mixture.components):
        print("component %i mean:" % k, c.mu)

    try:
        import matplotlib.pyplot as plt

        plt.figure(figsize=(10, 5))

        def set_axlimits():
            plt.xlim(-6.0, +6.0)
            plt.ylim(-0.2, +1.5)

        plt.subplot(121)
        plt.title("original mixture")
        pt.tools.plot_mixture(target_mix, cmap="jet")
        set_axlimits()

        plt.subplot(122)
        plt.title("variational fit")
        pt.tools.plot_mixture(fit_mixture, cmap="nipy_spectral")
        set_axlimits()

        plt.savefig("variational_example.png", dpi=100)
        plt.close("all")
        print("wrote variational_example.png")
    except ImportError:
        print('For plotting "matplotlib" needs to be installed')
    return {"data": data, "converged": converged, "mixture": fit_mixture}


if __name__ == "__main__":
    main()
