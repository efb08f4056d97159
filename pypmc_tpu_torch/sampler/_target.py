"""Target-density adapters.

Counterpart of :mod:`pypmc_tpu.sampler._target`.  A target is a callable
``x (D,) -> log P(x)`` on a tensor.  The samplers map a per-point target
over a batch with ``torch.func.vmap``; where that fails (a target that
leaves torch, e.g. through numpy, ``.item()`` or data-dependent Python
control flow), a host loop over the points takes over, as the JAX package
falls back for a target it cannot trace
(``pypmc_tpu/sampler/importance_sampling.py:47-55``, ``:207-218``).

Marking a target *batched* (:func:`batched_target`) hands it the whole
block at once: row-major ``(N, D)``, or with ``transposed=True`` the
samplers' own ``(D, N)`` layout (e.g.
:meth:`pypmc_tpu_torch.density.MixtureDensity.evaluate_fn` with
``batched=True``, which runs kernel ``fused_logq`` on the card).
"""

import logging

import torch

logger = logging.getLogger(__name__)

__all__ = ["batched_target", "is_batched", "is_transposed", "evaluate_target",
           "evaluate_target_T", "map_points"]

# what torch.func.vmap raises for a function that leaves torch: .item(),
# float() or int() of a tensor, data-dependent control flow, numpy on a
# tensor, a non-tensor result (the counterpart of the tracer-conversion
# errors the JAX package falls back on); any other error is a fault of the
# function and propagates
_UNMAPPABLE = (".item() on a Tensor", "data-dependent control flow",
               "doesn't have storage", "must only return Tensors")


def batched_target(fn=None, *, transposed=False):
    """Mark ``fn`` as a batched log-target: it receives row-major ``(N, D)``
    blocks, or with ``transposed=True`` ``(D, N)`` blocks, and returns
    ``(N,)`` log-densities.  Usable as a plain decorator or with
    arguments.  (The marks are the JAX package's attribute names.)"""

    def mark(f):
        f.__pypmc_tpu_batched__ = True
        f.__pypmc_tpu_transposed__ = transposed
        return f

    if fn is None:
        return mark
    return mark(fn)


def is_batched(fn) -> bool:
    return getattr(fn, "__pypmc_tpu_batched__", False)


def is_transposed(fn) -> bool:
    return getattr(fn, "__pypmc_tpu_transposed__", False)


def map_points(fn, samples):
    """A per-point ``fn`` over the rows of ``samples (N, D)`` -> ``(N, ...)``
    in the samples' dtype and device: ``torch.func.vmap``, or, where ``fn``
    leaves torch, a loop over the rows with one call (and one host sync)
    each, logged as a warning."""
    try:
        values = torch.func.vmap(fn)(samples)
    except (RuntimeError, ValueError) as err:
        if not any(s in str(err) for s in _UNMAPPABLE):
            raise
        logger.warning("%r cannot be mapped with torch.func.vmap (%s): evaluating its "
                       "%d points one at a time", fn, str(err).splitlines()[0], len(samples))
        values = torch.stack([torch.as_tensor(fn(x), dtype=samples.dtype,
                                              device=samples.device) for x in samples])
    return values.to(device=samples.device, dtype=samples.dtype)


def evaluate_target(target, samples):
    """Evaluate ``target`` on a row-major ``(N, D)`` tensor block."""
    if is_batched(target):
        if is_transposed(target):
            return target(samples.T.contiguous())
        return target(samples)
    return map_points(target, samples)


def evaluate_target_T(target, samples_T):
    """Evaluate ``target`` on a transposed ``(D, N)`` tensor block; only a
    transposed batched target avoids the layout change."""
    if is_batched(target) and is_transposed(target):
        return target(samples_T)
    return evaluate_target(target, samples_T.T)
