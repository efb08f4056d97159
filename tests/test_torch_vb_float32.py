"""The port's float32 VB fit on the one-pass E-step, on the CPU.

From 1024 points ``GaussianInference`` takes the one-pass E-step (here its
plain version), whose statistics are formed around float32 operands.  On
``examples/variational.py``'s mixture at 2048 and 4096 points, seeds 1-13,
the port's float32 fit converges wherever the JAX package's float32 fit
(x64 off, its XLA path on the CPU) does, and to the two components of the
port's float64 fit of the same points (which
``test_torch_variational.py`` holds to the JAX package's float64 fit).
"""

import jax
import numpy as np
import pytest
import torch

import pypmc_tpu as jpt
import pypmc_tpu_torch
from pypmc_tpu_torch.mix_adapt.variational import GaussianInference
from pypmc_tpu_torch.ops import kernels

torch.set_num_threads(1)

# a fit's iterations at most: the float32 fits at these sizes converge
# within 150-1400 (the port's at n=4096, seed 13, takes 1384, by way of a
# third component that the other fits merge sooner)
ITERATIONS = 3000


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port runs on the card unless the CPU is asked for: ask for it."""
    with pypmc_tpu_torch.using_device("cpu"):
        yield


def example_data(seed, n):
    """``examples/variational.py``'s mixture, ``n`` draws with seed ``seed``."""
    mix = jpt.density.create_gaussian_mixture(
        [np.array([5.0, 0.01]), np.array([-4.0, 1.0])],
        [np.array([[0.01, 0.003], [0.003, 0.0025]]), np.array([[0.1, 0.0], [0.0, 0.02]])],
        np.array([0.3, 0.7]))
    return np.asarray(mix.propose(n, rng=seed))


@pytest.mark.parametrize("n", [2048, 4096])
@pytest.mark.parametrize("seed", range(1, 14))
def test_one_pass_float32_fit_stops_where_the_jax_packages_does(n, seed):
    """The port's float32 fit converges wherever the JAX package's float32
    fit does; its weights and means agree with the port's float64 fit to
    3e-5 (float32 sums over the points, and a bound that stops while the
    means still move by ~1e-6)."""
    data = example_data(seed, n)
    with jax.enable_x64(False):
        converged = jpt.mix_adapt.GaussianInference(data, 20).run(ITERATIONS) is not None
    kernels.reset_launch_counts()
    vb = GaussianInference(torch.tensor(data, dtype=torch.float32), 20)
    it = vb.run(ITERATIONS)
    assert kernels.launch_counts()["plain:fused_vb_estep"] == 0    # the one-pass route
    assert converged
    assert it is not None, "the port's float32 fit did not converge"
    ref = GaussianInference(torch.tensor(data), 20)
    assert ref.run(ITERATIONS) is not None
    got, want = vb.make_mixture(), ref.make_mixture()
    assert len(got) == len(want) == 2
    order_g, order_w = np.argsort(got.weights), np.argsort(want.weights)
    np.testing.assert_allclose(np.asarray(got.weights)[order_g],
                               np.asarray(want.weights)[order_w], rtol=3e-5)
    for a, b in zip(order_g, order_w):
        np.testing.assert_allclose(got.components[a].mu, want.components[b].mu,
                                   rtol=3e-5, atol=3e-5)


if __name__ == "__main__":
    # the iterations of each fit (None: not converged in ITERATIONS): the
    # JAX package's float32 fit on the CPU (its XLA path) and on its
    # one-pass route (the Pallas kernel in interpret mode, as on a TPU), the
    # port's float32 fit with its operands held and rounded afresh every
    # iteration (as before the hold), and its float64 fit
    import logging
    import os

    from pypmc_tpu_torch.mix_adapt import variational

    jax.config.update("jax_enable_x64", True)
    pypmc_tpu_torch.set_default_device("cpu")
    logging.disable(logging.WARNING)
    held = variational._held_operands

    def port(data, dtype, hold=True):
        variational._held_operands = held if hold else (
            lambda operands, scales, _, dt: held(operands, scales, None, dt))
        return GaussianInference(torch.tensor(data, dtype=dtype), 20).run(ITERATIONS)

    print("n     seed  JAX f32  JAX f32 one-pass  port f32  port f32 unheld  port f64")
    for n in (2048, 4096):
        for seed in range(1, 14):
            data = example_data(seed, n)
            with jax.enable_x64(False):
                xla = jpt.mix_adapt.GaussianInference(data, 20).run(ITERATIONS)
                os.environ["PYPMC_TPU_PALLAS_INTERPRET"] = "1"
                one_pass = jpt.mix_adapt.GaussianInference(data, 20)
                assert one_pass._fused_eligible() == "dense"
                one_pass = one_pass.run(ITERATIONS)
                del os.environ["PYPMC_TPU_PALLAS_INTERPRET"]
            print("%-5d %4d  %7s  %16s  %8s  %15s  %8s" % (
                n, seed, xla, one_pass, port(data, torch.float32),
                port(data, torch.float32, hold=False), port(data, torch.float64)), flush=True)
