"""Support tools: sample storage, convergence diagnostics, indicators and
logging.  (Plotting, ``pypmc_tpu.tools._plot``, is not ported yet.)"""

from . import indicator
from ..density._partition import partition, patch_data
from ._history import History
from .convergence import ess, perp
from .util import log_to_stdout

__all__ = ["History", "partition", "patch_data", "perp", "ess", "log_to_stdout",
           "indicator"]
