"""The port's device rule: the card, unless the caller asks for the CPU.

Every public function or class of the package that builds tensors from
host data (numpy arrays, lists, the host density classes) takes
``device=None``, meaning :func:`default_device`: CUDA device 0's current
device.  Where CUDA is absent, :func:`default_device` raises rather than
carry on on the CPU; a caller asks for the CPU with ``device="cpu"`` on
the call, with :func:`set_default_device`, or for a block of code with
:func:`using_device`::

    with pypmc_tpu_torch.using_device("cpu"):
        result = pypmc_tpu_torch.pipeline.integrate(...)

A tensor the caller passes keeps its device.  The working dtype of host
data is float32 on the card (the kernels' type) and float64 on the CPU
(where the plain versions run, as the JAX package's tests run x64).
"""

import contextlib

import torch

__all__ = ["default_device", "set_default_device", "using_device", "working_dtype"]

_requested = None   # a torch.device the caller asked for, or None for the card


def set_default_device(device):
    """Make ``device`` (e.g. ``"cpu"``) the default of every entry point;
    None restores the card."""
    global _requested
    _requested = None if device is None else torch.device(device)


@contextlib.contextmanager
def using_device(device):
    """:func:`set_default_device` for the body of a ``with`` block."""
    global _requested
    previous = _requested
    set_default_device(device)
    try:
        yield
    finally:
        _requested = previous


def default_device(device=None) -> torch.device:
    """``device`` itself if given, else the requested default, else the
    card.  Raises ``RuntimeError`` when the card is meant and CUDA is not
    available."""
    if device is not None:
        return torch.device(device)
    if _requested is not None:
        return _requested
    if not torch.cuda.is_available():
        raise RuntimeError(
            "pypmc_tpu_torch runs on the CUDA device by default, and CUDA is "
            "not available here; ask for the CPU with device='cpu', "
            "pypmc_tpu_torch.set_default_device('cpu') or "
            "pypmc_tpu_torch.using_device('cpu')")
    return torch.device("cuda", torch.cuda.current_device())


def working_dtype(device) -> torch.dtype:
    """float32 on CUDA, float64 elsewhere."""
    return torch.float32 if torch.device(device).type == "cuda" else torch.float64


def as_tensor(x, device=None, dtype=None) -> torch.Tensor:
    """``x`` as a tensor: a tensor keeps its device (and its dtype unless
    ``dtype`` is given); host data goes to :func:`default_device` of
    ``device`` in ``dtype`` or the working dtype there."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype)
    device = default_device(device)
    return torch.as_tensor(x, dtype=dtype or working_dtype(device), device=device)
