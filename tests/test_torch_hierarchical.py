"""pypmc_tpu_torch.mix_adapt.hierarchical against
pypmc_tpu.mix_adapt.hierarchical: the counterparts of
``tests/test_mix_adapt_tools.py``'s hierarchical tests, and one run of both
packages on the same float64 input.  Both compute the same float64 KL
matrix and moment matches in other orders, so the runs take the same steps
and agree to RTOL64."""

import numpy as np
import pytest
import torch

from pypmc_tpu.density import create_gaussian_mixture as jax_create_gaussian_mixture
from pypmc_tpu.mix_adapt.hierarchical import Hierarchical as JaxHierarchical
import pypmc_tpu_torch
from pypmc_tpu_torch.density import create_gaussian_mixture
from pypmc_tpu_torch.mix_adapt import Hierarchical, kl_divergence_matrix, kullback_leibler

torch.set_num_threads(1)

RTOL64, ATOL64 = 1e-10, 1e-12


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port runs on the card unless the CPU is asked for: ask for it."""
    with pypmc_tpu_torch.using_device("cpu"):
        yield


def test_kl_identical_zero():
    c = create_gaussian_mixture([np.zeros(2)], [np.eye(2)]).components[0]
    assert np.isclose(kullback_leibler(c, c), 0.0)


def test_kl_closed_form_1d():
    v1, v2, m1, m2 = 0.5, 2.0, 1.0, -1.0
    c1, c2 = create_gaussian_mixture([np.array([m1]), np.array([m2])],
                                     [np.array([[v1]]), np.array([[v2]])]).components
    expected = 0.5 * (np.log(v2 / v1) + v1 / v2 + (m1 - m2) ** 2 / v2 - 1)
    assert np.isclose(kullback_leibler(c1, c2), expected)
    t = lambda v: torch.tensor(v, dtype=torch.float64)
    kl = kl_divergence_matrix(t([[m1]]), t([[[v1]]]), t([[m2]]), t([[[v2]]]))
    np.testing.assert_allclose(kl.numpy(), [[expected]], rtol=RTOL64)


def make_input(create):
    rng = np.random.default_rng(0)
    means = np.vstack([rng.normal([0, 0], 0.2, size=(8, 2)),
                       rng.normal([6, 6], 0.2, size=(12, 2))])
    return create(means, np.array([np.eye(2) * 0.4] * 20), np.ones(20))


def test_reduces_to_two_modes():
    guess = create_gaussian_mixture(
        [np.array([1.0, 1.0]), np.array([5.0, 5.0]), np.array([3.0, 3.0])], [np.eye(2)] * 3)
    h = Hierarchical(make_input(create_gaussian_mixture), guess)
    steps = h.run()
    assert steps is not None
    assert len(h.g) == 2
    means = sorted([c.mu[0] for c in h.g.components])
    assert np.isclose(means[0], 0.0, atol=0.3)
    assert np.isclose(means[1], 6.0, atol=0.3)
    # moment-matched weights: 8/20 and 12/20
    assert np.allclose(sorted(h.g.weights), [0.4, 0.6], atol=1e-6)


def test_rejects_fewer_inputs_than_outputs():
    mix_in = create_gaussian_mixture([np.zeros(2)], [np.eye(2)])
    guess = create_gaussian_mixture([np.zeros(2), np.ones(2)], [np.eye(2)] * 2)
    with pytest.raises(AssertionError):
        Hierarchical(mix_in, guess)


def test_invalid_output_covariance_gives_an_inf_column():
    """An output covariance whose Cholesky factorization fails gives an
    all-inf KL column: no input is assigned to it."""
    rng = np.random.default_rng(1)
    mu1 = torch.tensor(rng.normal(size=(5, 3)))
    cov1 = torch.eye(3, dtype=torch.float64).expand(5, 3, 3).clone()
    mu2 = torch.tensor(rng.normal(size=(3, 3)))
    cov2 = torch.eye(3, dtype=torch.float64).expand(3, 3, 3).clone()
    cov2[1] = -cov2[1]                      # negative definite
    kl = kl_divergence_matrix(mu1, cov1, mu2, cov2)
    assert torch.isinf(kl[:, 1]).all() and (kl[:, 1] > 0).all()
    assert torch.isfinite(kl[:, [0, 2]]).all()
    assert not (kl.argmin(dim=1) == 1).any()


def test_run_matches_jax():
    """The reduction of 20 inputs from a 3-component guess, in both
    packages on the same float64 input: the same steps, and the same
    surviving means, covariances and weights."""
    mk = lambda create: create(
        [np.array([1.0, 1.0]), np.array([5.0, 5.0]), np.array([3.0, 3.0])], [np.eye(2)] * 3)
    h = Hierarchical(make_input(create_gaussian_mixture), mk(create_gaussian_mixture))
    j = JaxHierarchical(make_input(jax_create_gaussian_mixture), mk(jax_create_gaussian_mixture))
    assert h.run() == j.run()
    assert len(h.g) == len(j.g)
    np.testing.assert_allclose(h.g.weights, j.g.weights, rtol=RTOL64, atol=ATOL64)
    for f in ("mu", "sigma"):
        np.testing.assert_allclose([getattr(c, f) for c in h.g.components],
                                   [getattr(c, f) for c in j.g.components],
                                   rtol=RTOL64, atol=ATOL64, err_msg=f)
    np.testing.assert_allclose(h.min_kl, j.min_kl, rtol=1e-8, atol=1e-12)
