"""Profiling helpers.  (Counterpart of :mod:`pypmc_tpu.profiling`.)

:func:`trace` records a run with ``torch.profiler`` (host and CUDA
activity) and writes a Chrome trace; :func:`timed` wall-clocks a block with
the card synchronized at both ends.  The stages of
:func:`pypmc_tpu_torch.pipeline.integrate` and each step of
:func:`pypmc_tpu_torch.parallel.pmc_run_sharded` open a named range
(:func:`annotate`) that shows in a trace beside the kernels it launched.
"""

import contextlib
import os
import tempfile
import time

import torch

from . import _device

__all__ = ["trace", "timed"]


@contextlib.contextmanager
def trace(logdir=None):
    """Record the block with ``torch.profiler`` -- host operators, the
    ranges of :func:`annotate` and, where CUDA is available, the card's
    kernels and copies -- and write it as a Chrome trace
    ``trace_<pid>.json`` under ``logdir`` (default: ``pypmc_tpu_torch_trace``
    in the temporary directory).  Yields ``logdir``."""
    from torch.profiler import ProfilerActivity, profile

    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "pypmc_tpu_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield logdir
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace_%d.json" % os.getpid()))


def _synchronize():
    """Wait for the card's pending work where the port runs on the card;
    on the CPU (or without CUDA) touch nothing."""
    try:
        device = _device.default_device()
    except RuntimeError:   # no CUDA, and the CPU not asked for: nothing pending
        return
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def timed(label="block", results=None):
    """Wall-clock a block, waiting for the card's pending work at entry and
    exit so that asynchronous launches do not skew the number.  Appends
    ``(label, seconds)`` to ``results`` if given."""
    _synchronize()
    t0 = time.perf_counter()
    yield
    _synchronize()
    dt = time.perf_counter() - t0
    if results is not None:
        results.append((label, dt))


def annotate(name):
    """A range named ``name`` in a :func:`trace` (``record_function``; an
    NVTX range under ``torch.autograd.profiler.emit_nvtx``); outside a
    profiled block, a context that does nothing."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()
