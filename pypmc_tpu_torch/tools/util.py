"""Logging helpers.  (Counterpart of :mod:`pypmc_tpu.tools.util`, the
reference's ``pypmc/tools/util.py``.)"""

import logging
import sys

import torch

__all__ = ["log_to_stdout"]

_HANDLER_NAME = "pypmc_tpu_torch_stdout_handler"


def log_to_stdout(verbose=False):
    """Install (idempotently) a stdout handler on the package logger;
    ``verbose`` switches the level from WARNING to INFO.  In an initialized
    ``torch.distributed`` group only rank 0 logs below ERROR."""
    logger = logging.getLogger("pypmc_tpu_torch")
    level = logging.INFO if verbose else logging.WARNING
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() and dist.get_rank() != 0:
        level = logging.ERROR
    logger.setLevel(level)
    for handler in logger.handlers:
        if handler.get_name() == _HANDLER_NAME:
            handler.setLevel(level)
            return
    handler = logging.StreamHandler(sys.stdout)
    handler.set_name(_HANDLER_NAME)
    handler.setLevel(level)
    logger.addHandler(handler)
