"""Proposal adaptation: the functional core of PMC.  The host classes, VB,
hierarchical reduction and Gelman-Rubin grouping are not ported yet."""

from .pmc import pmc_log_likelihood, pmc_update
