"""pypmc_tpu_torch.tools' plotting, the cases of tests/test_plot.py with
the Agg backend, and its ellipses against the JAX package's."""

import numpy as np
import pytest

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import torch  # noqa: E402

from pypmc_tpu.tools import _plot as jax_plot  # noqa: E402
from pypmc_tpu_torch.density import create_gaussian_mixture, create_t_mixture  # noqa: E402
from pypmc_tpu_torch.tools import _plot, plot_mixture, plot_responsibility  # noqa: E402
from pypmc_tpu_torch.tools import _probability_densities as pdens  # noqa: E402

MEANS = np.array([[0.0, 0.0], [3.0, 3.0], [-2.0, 1.0]])
COVS = np.array([np.eye(2) * 0.5, [[1.0, 0.4], [0.4, 0.8]], np.eye(2)])
WEIGHTS = np.array([0.5, 0.3, 0.2])


def test_plot_mixture_draws_ellipses():
    plt.figure()
    mix = create_gaussian_mixture(MEANS, COVS, WEIGHTS)
    plot_mixture(mix)
    # one filled and one edge ellipse a component, and the centres' scatter
    assert len(plt.gca().patches) == 2 * len(mix)
    assert len(plt.gca().collections) == 1
    plt.close("all")


def test_plot_mixture_cutoff_and_weights():
    plt.figure()
    mix = create_t_mixture(MEANS, COVS, np.full(3, 5.0), WEIGHTS)
    mappable = plot_mixture(mix, cutoff=0.25, visualize_weights=True)
    assert len(plt.gca().patches) == 2 * 2   # two components pass the cutoff
    assert mappable is not None               # usable for plt.colorbar
    plt.close("all")


def test_plot_mixture_rejects_bad_axes():
    mix = create_gaussian_mixture(MEANS, COVS, WEIGHTS)
    with pytest.raises(AssertionError):
        plot_mixture(mix, i=1, j=1)
    plt.close("all")


def test_plot_responsibility():
    plt.figure()
    rng = np.random.default_rng(0)
    plot_responsibility(rng.normal(size=(50, 2)), torch.tensor(rng.random((50, 3))))
    assert len(plt.gca().collections) >= 1
    plt.close("all")


def test_plot_responsibility_validates_shapes():
    with pytest.raises(AssertionError):
        plot_responsibility(np.zeros((10, 3)), np.zeros((10, 2)))   # 3-D data
    with pytest.raises(AssertionError):
        plot_responsibility(np.zeros((10, 2)), np.zeros((5, 2)))    # length mismatch


@pytest.mark.parametrize("cov", [COVS[1], np.diag([0.3, 2.0]), np.array([[1.0, -0.9], [-0.9, 1.0]])])
def test_ellipse_params_match_the_jax_package(cov):
    np.testing.assert_allclose(_plot._ellipse_params(cov), jax_plot._ellipse_params(cov),
                               rtol=1e-14)


def test_ellipse_params_refuse_a_negative_eigenvalue():
    with pytest.raises(ValueError, match="negative eigenvalues"):
        _plot._ellipse_params(np.array([[1.0, 2.0], [2.0, 1.0]]))


def test_probability_densities_match_the_jax_package():
    from pypmc_tpu.tools import _probability_densities as jdens

    rng = np.random.default_rng(3)
    a = rng.normal(size=(3, 3))
    inv_sigma = a @ a.T + np.eye(3)
    x, mu = rng.normal(size=3), rng.normal(size=3)
    for name in ("unnormalized_log_pdf_gauss", "normalized_pdf_gauss"):
        got = getattr(pdens, name)(torch.tensor(x), torch.tensor(mu), torch.tensor(inv_sigma))
        ref = getattr(jdens, name)(x, mu, inv_sigma)
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-12, err_msg=name)
