"""Adaptive Metropolis sampling on the card: the port's counterpart of
``examples/markov_chain.py`` (the reference's workload).  A local
Student-t proposal adapts its covariance to a narrow correlated 2-D
Gaussian target: 10^4 burn-in steps, then 200 runs of 500 steps, the
proposal adapted after each.

    python examples_torch/markov_chain.py

The chain steps on the device, one Python iteration a step
(``MarkovChain._run_device``), where the JAX package runs one compiled
``lax.scan`` a run.
"""

import argparse
import time

import numpy as np
import torch

import pypmc_tpu_torch as pt

# define a proposal
prop_dof = 1.0
prop_sigma = np.array([[0.1, 0.0], [0.0, 0.02]])

# define the target: log of an unnormalized Gaussian density
target_sigma = np.array([[0.01, 0.003], [0.003, 0.0025]])
target_mean = np.array([4.3, 1.1])

# choose a bad initialization
start = np.array([-2.0, 10.0])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--burn-in", type=int, default=10**4)
    ap.add_argument("--runs", type=int, default=200)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    with pt.using_device(args.device):
        return run(args.burn_in, args.runs, args.steps, pt.default_device())


def run(burn_in, runs, steps, device):
    prop = pt.density.LocalStudentT(prop_sigma, prop_dof)
    dtype = pt.working_dtype(device)
    inv_target_sigma = torch.as_tensor(np.linalg.inv(target_sigma), dtype=dtype, device=device)
    mean = torch.as_tensor(target_mean, dtype=dtype, device=device)

    def log_target(x):
        diff = x - mean
        return -0.5 * diff @ inv_target_sigma @ diff

    mc = pt.sampler.AdaptiveMarkovChain(log_target, prop, start, rng=0)

    t0 = time.perf_counter()
    # run burn-in and discard it
    mc.run(burn_in)
    mc.clear()

    # run runs x steps adapting the proposal after each run
    accept_count = 0
    for i in range(runs):
        accept_count += mc.run(steps)
        mc.adapt()
    seconds = time.perf_counter() - t0   # each run ends in a copy to the host

    values = mc.samples[:]
    accept_rate = float(accept_count) / len(values)
    print("The chain accepted %4.2f%% of the proposed points" % (accept_rate * 100))
    print("sample mean:", values.mean(axis=0), " (target:", target_mean, ")")
    print("sample cov:\n", np.cov(values, rowvar=0), "\n(target:\n", target_sigma, ")")

    try:
        import matplotlib.pyplot as plt

        plt.figure()
        plt.hexbin(values[:, 0], values[:, 1], gridsize=40, cmap="gray_r")
        plt.savefig("markov_chain_example.png", dpi=100)
        plt.close("all")
        print("wrote markov_chain_example.png")
    except ImportError:
        print('For plotting "matplotlib" needs to be installed')
    n_steps = burn_in + runs * steps
    return {"accept_rate": accept_rate, "mean": values.mean(axis=0).tolist(),
            "cov": np.cov(values, rowvar=0).tolist(), "chain_steps": n_steps,
            "seconds": seconds, "us_per_step": seconds / n_steps * 1e6}


if __name__ == "__main__":
    main()
