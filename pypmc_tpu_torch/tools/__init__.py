"""Support tools: sample storage, convergence diagnostics, indicators,
plotting and logging."""

from . import indicator
from ..density._partition import partition, patch_data
from ._history import History
from .convergence import ess, perp
from .util import log_to_stdout

__all__ = ["History", "partition", "patch_data", "perp", "ess", "log_to_stdout",
           "indicator", "plot_mixture", "plot_responsibility"]


def plot_mixture(*args, **kwargs):
    """Lazy re-export of :func:`pypmc_tpu_torch.tools._plot.plot_mixture`
    (requires matplotlib)."""
    from ._plot import plot_mixture as _plot_mixture

    return _plot_mixture(*args, **kwargs)


def plot_responsibility(*args, **kwargs):
    """Lazy re-export of
    :func:`pypmc_tpu_torch.tools._plot.plot_responsibility` (requires
    matplotlib)."""
    from ._plot import plot_responsibility as _plot_responsibility

    return _plot_responsibility(*args, **kwargs)
