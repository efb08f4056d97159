"""Indicator functions restricting the support of a target density.

Counterpart of :mod:`pypmc_tpu.tools.indicator` (the reference's
``pypmc/tools/indicator``).  The indicators take a point ``x (D,)`` as a
tensor and return a boolean tensor, written with torch operations, so that
:func:`merge_function_with_indicator` can merge them into a target that
``torch.func.vmap`` maps over a batch of points.
"""

import numpy as _np
import torch

from .. import _device

__all__ = ["ball", "hyperrectangle", "merge_function_with_indicator"]


def _point(x, like):
    """``x`` as a tensor on ``like``'s device and dtype, its last axis
    checked against ``like``'s length."""
    if isinstance(x, torch.Tensor):
        x = x.to(like.dtype)
    else:
        x = torch.as_tensor(x, dtype=like.dtype, device=like.device)
    if x.shape[-1] != like.shape[0]:
        raise ValueError("input has wrong dimension (%d, expected %d)"
                         % (x.shape[-1], like.shape[0]))
    return x


def ball(center, radius=1.0, bdy=True, device=None):
    """Return the indicator function of a ball.

    :param center: Vector-like array; ``len(center)`` fixes the dimension.
    :param radius: Float; the ball's radius.
    :param bdy: Bool; whether a point exactly on the boundary counts as
        inside.  (Reference: ``_indicator_factory.py:5-48``.)
    :param device: where a host ``center`` goes (default:
        :func:`pypmc_tpu_torch.default_device`).
    """
    center = _device.as_tensor(center, device)

    def ball_indicator(x):
        dist = torch.linalg.vector_norm(_point(x, center) - center, dim=-1)
        return dist <= radius if bdy else dist < radius

    ball_indicator.__doc__ = (
        "ball indicator:"
        "\ncenter = %s\nradius = %s\nbdy    = %s" % (center, radius, bdy)
    )
    return ball_indicator


def hyperrectangle(lower, upper, bdy=True, device=None):
    """Return the indicator function of a hyperrectangle.
    (Reference: ``_indicator_factory.py:50-97``.)"""
    host = lambda v: v.cpu().numpy() if isinstance(v, torch.Tensor) else _np.asarray(v)
    if _np.any(host(upper) <= host(lower)):
        raise ValueError("every upper bound must exceed its lower bound")
    lower = _device.as_tensor(lower, device)
    upper = _device.as_tensor(upper, lower.device, lower.dtype)

    def hr_indicator(x):
        x = _point(x, lower)
        if bdy:
            return torch.all(lower <= x, dim=-1) & torch.all(x <= upper, dim=-1)
        return torch.all(lower < x, dim=-1) & torch.all(x < upper, dim=-1)

    hr_indicator.__doc__ = (
        "hyperrectangle indicator:"
        "\nlower = %s\nupper = %s\nbdy   = %s" % (lower, upper, bdy)
    )
    return hr_indicator


def merge_function_with_indicator(function, indicator, alternative):
    """Return a function equivalent to
    ``function(x) if indicator(x) else alternative``, written with
    ``torch.where`` so that it maps over a batch.

    .. note::
        Unlike the reference (``_indicator_merge.py:1-33``), BOTH branches
        are evaluated and the result is selected; ``function`` must
        therefore not crash outside the support (it may return NaN/inf
        there: the indicator masks it).  A batched ``function``
        (:func:`pypmc_tpu_torch.sampler.batched_target`) stays batched, the
        indicator mapped over its points.
    """
    if indicator is None:
        return function

    from ..sampler._target import batched_target, is_batched, is_transposed

    def select(ok, value):
        if not isinstance(value, torch.Tensor):
            value = torch.tensor(float(value), dtype=torch.float64, device=ok.device)
        return torch.where(ok, value, torch.full_like(value, alternative))

    if is_batched(function) and is_transposed(function):
        @batched_target(transposed=True)
        def merged_function(xT):
            return select(torch.func.vmap(indicator, in_dims=1)(xT), function(xT))

    elif is_batched(function):
        @batched_target
        def merged_function(x):
            return select(torch.func.vmap(indicator)(x), function(x))

    else:

        def merged_function(x):
            return select(torch.as_tensor(indicator(x)), function(x))

    return merged_function
