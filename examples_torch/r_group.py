"""Group Markov chains by the Gelman-Rubin R value on the card: the port's
counterpart of ``examples/r_group.py`` (the reference's workload).  Five
chains started in the two modes of a bimodal target only explore their own
mode; ``r_group`` recovers the two chain groups, and ``make_r_gaussmix``
builds a long-patches mixture from them.

    python examples_torch/r_group.py

Each chain is an ``AdaptiveMarkovChain`` stepping on the device, one
Python iteration a step (``MarkovChain._run_device``).  :func:`group` is
the grouping part alone, for given chain samples.
"""

import argparse
import time

import numpy as np

import pypmc_tpu_torch as pt

# the same initial local Student-t proposal for all chains
prop_dof = 50.0
prop_sigma = np.array([[0.1, 0.0], [0.0, 0.02]])

# bimodal Gaussian target with well separated modes
component_weights = np.array([0.3, 0.7])
mean0 = np.array([5.0, 0.01])
covariance0 = np.array([[0.01, 0.003], [0.003, 0.0025]])
mean1 = np.array([-4.0, 1.0])
covariance1 = np.array([[0.1, 0.0], [0.0, 0.02]])

expected_groups = [[0, 1], [2, 3, 4]]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--burn-in", type=int, default=10**2)
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    with pt.using_device(args.device):
        pt.default_device()   # raises without CUDA unless --device asks for the CPU
        return run(args.burn_in, args.runs, args.steps)


def group(stacked_values):
    """The chains' R-value groups and their long-patches mixture."""
    found_groups = pt.mix_adapt.r_group(
        [np.mean(chain, axis=0) for chain in stacked_values],
        [np.var(chain, axis=0) for chain in stacked_values],
        len(stacked_values[0]))
    return found_groups, pt.mix_adapt.make_r_gaussmix(stacked_values)


def run(burn_in, runs, steps):
    prop = pt.density.LocalStudentT(prop_sigma, prop_dof)
    target_mixture = pt.density.create_gaussian_mixture(
        [mean0, mean1], [covariance0, covariance1], component_weights)
    log_target = target_mixture.evaluate_fn()

    # two chains in the mode at [5, 0.01], three in the mode at [-4, 1]
    starts = [np.array([4.999, 0.0])] * 2 + [np.array([-4.0001, 0.999])] * 3

    mcs = [pt.sampler.AdaptiveMarkovChain(log_target, prop, start, rng=seed)
           for seed, start in enumerate(starts)]

    t0 = time.perf_counter()
    # run and discard burn-in
    for mc in mcs:
        mc.run(burn_in)
        mc.clear()

    # run runs x steps adapting the proposal after each run
    for mc in mcs:
        for i in range(runs):
            mc.run(steps)
            mc.adapt()
    seconds = time.perf_counter() - t0   # each run ends in a copy to the host

    stacked_values = [mc.samples[:] for mc in mcs]
    found_groups, result = group(stacked_values)
    print("Expect %s" % expected_groups)
    print("Have   %s" % found_groups)
    print("long-patches mixture with %d components" % len(result))

    try:
        import matplotlib.pyplot as plt

        plt.figure()
        pt.tools.plot_mixture(result, cmap="jet")
        plt.savefig("r_group_example.png", dpi=100)
        plt.close("all")
        print("wrote r_group_example.png")
    except ImportError:
        print('For plotting "matplotlib" needs to be installed')
    n_steps = len(mcs) * (burn_in + runs * steps)
    return {"groups": found_groups, "mixture": result, "chain_steps": n_steps,
            "seconds": seconds, "us_per_step": seconds / n_steps * 1e6}


if __name__ == "__main__":
    main()
