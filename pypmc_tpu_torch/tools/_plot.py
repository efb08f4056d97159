"""Mixture visualization (requires matplotlib).

Counterpart of :mod:`pypmc_tpu.tools._plot` (the reference's
``pypmc/tools/_plot.py``): 1-sigma covariance ellipses per component
(optionally colored by component weight) and responsibility-colored
scatter plots, drawn from host numpy arrays.
"""

import numpy as _np

__all__ = ["plot_mixture", "plot_responsibility"]


def _host(x):
    """``x`` as a host numpy array (a tensor is copied off its device)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return _np.asarray(x)


def _ellipse_params(cov):
    """Return (width, height, angle_deg) of the 1-sigma ellipse of a 2x2
    covariance via eigendecomposition."""
    evals, evecs = _np.linalg.eigh(cov)
    if (evals < 0).any():
        raise ValueError("Covariance has negative eigenvalues %s" % evals)
    angle = _np.degrees(_np.arctan2(evecs[1, 1], evecs[0, 1]))
    # 2 sqrt(lambda): full width/height of the 1-sigma ellipse
    width = 2.0 * _np.sqrt(evals[1])
    height = 2.0 * _np.sqrt(evals[0])
    return width, height, angle


def plot_mixture(mixture, i=0, j=1, center_style=dict(s=0.15),
                 cmap="nipy_spectral", cutoff=0.0, ellipse_style=dict(alpha=0.3),
                 solid_edge=True, visualize_weights=False):
    """Plot the (i, j) marginal projection of a Gaussian/Student-t mixture:
    one 1-sigma ellipse per component.

    :param mixture: :class:`~pypmc_tpu_torch.density.mixture.MixtureDensity`
        with Gauss or StudentT components.
    :param i, j: dimensions to project onto (i != j).
    :param center_style: kwargs for the component-center scatter; falsy to
        disable.
    :param cmap: matplotlib colormap name used to color components.
    :param cutoff: skip components with weight below this value.
    :param ellipse_style: kwargs for the ellipse patches; the ``color`` key
        overrides the colormap.
    :param solid_edge: draw an opaque edge around each ellipse.
    :param visualize_weights: color the ellipses by component weight
        (colorbar-able via the returned mappable).
    """
    import matplotlib.pyplot as plt
    from matplotlib.colors import Normalize
    from matplotlib.patches import Ellipse

    assert i >= 0 and j >= 0, "i and j must be non-negative"
    assert i != j, "i must not equal j"

    mask = mixture.weights >= cutoff
    means = _np.array([c.mu for c in mixture.components])[mask]
    covs = _np.array([c.sigma for c in mixture.components])[mask]
    weights = _np.asarray(mixture.weights)[mask]

    ax = plt.gca()
    colormap = plt.get_cmap(cmap)

    if visualize_weights:
        norm = Normalize(vmin=0.0, vmax=1.0)
        colors = [colormap(norm(w)) for w in weights]
        mappable = plt.cm.ScalarMappable(norm=norm, cmap=colormap)
        mappable.set_array(weights)
    else:
        colors = [colormap(v) for v in _np.linspace(0, 0.9, len(weights))]
        mappable = None

    for k, (mean, cov) in enumerate(zip(means, covs)):
        sub = cov[_np.ix_([i, j], [i, j])]
        width, height, angle = _ellipse_params(sub)
        style = dict(ellipse_style)
        color = style.pop("color", colors[k])
        ax.add_patch(Ellipse(xy=(mean[i], mean[j]), width=width, height=height,
                             angle=angle, color=color, **style))
        if solid_edge:
            ax.add_patch(Ellipse(xy=(mean[i], mean[j]), width=width, height=height,
                                 angle=angle, edgecolor=color, facecolor="none"))

    if center_style:
        ax.scatter(means[:, i], means[:, j], **center_style)

    ax.autoscale_view()
    return mappable


def plot_responsibility(data, responsibility, cmap="nipy_spectral"):
    """Classify the 2-D ``data`` by the argmax of the ``(N, K)``
    ``responsibility`` matrix (e.g. ``GaussianInference.r``; tensors are
    copied to the host) and scatter-plot it with one color per component."""
    import matplotlib.pyplot as plt

    data = _host(data)
    responsibility = _host(responsibility)
    assert data.ndim == 2, "``data`` must be matrix like"
    assert data.shape[1] == 2, "can only plot 2D data"
    assert len(data) == len(responsibility), (
        "Number of points in ``data`` (%i) does not match the number of "
        "rows in ``responsibility`` (%i)" % (len(data), len(responsibility)))

    owner = responsibility.argmax(axis=1)
    K = responsibility.shape[1]
    colormap = plt.get_cmap(cmap)
    colors = [colormap(v) for v in _np.linspace(0, 0.9, K)]
    for k in range(K):
        sel = owner == k
        if sel.any():
            plt.scatter(data[sel, 0], data[sel, 1], color=colors[k], s=4)
