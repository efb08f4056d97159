"""Proposal adaptation: PMC, variational Bayes and Gelman-Rubin grouping.
The hierarchical reduction (``pypmc_tpu.mix_adapt.hierarchical``) is not
ported yet."""

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
