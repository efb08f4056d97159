"""The PMC run loop over the particle axis, for one process on one device."""

from .sampler import pmc_run_sharded, run_is_step_sharded
