"""Proposal adaptation: the functional core of PMC and variational Bayes.
The PMC host classes, hierarchical reduction and Gelman-Rubin grouping are
not ported yet."""

from .pmc import pmc_log_likelihood, pmc_update
from .variational import (
    Dirichlet_log_C,
    GaussianInference,
    VBMerge,
    Wishart_H,
    Wishart_expect_log_lambda,
    Wishart_log_B,
)
