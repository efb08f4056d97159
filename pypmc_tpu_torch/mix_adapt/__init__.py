"""Proposal adaptation: PMC, variational Bayes, hierarchical reduction and
Gelman-Rubin grouping."""

from .hierarchical import Hierarchical, kl_divergence_matrix, kullback_leibler
from .pmc import PMC, gaussian_pmc, pmc_log_likelihood, pmc_update, student_t_pmc
from .r_value import make_r_gaussmix, make_r_tmix, r_group, r_value
from .variational import (
    Dirichlet_log_C,
    GaussianInference,
    VBMerge,
    Wishart_H,
    Wishart_expect_log_lambda,
    Wishart_log_B,
)
