"""Analytic Gaussian densities used by tests and examples, on tensors.
(Counterpart of :mod:`pypmc_tpu.tools._probability_densities`, the
reference's ``pypmc/tools/_probability_densities.py``.)"""

import math

import torch

__all__ = ["unnormalized_log_pdf_gauss", "normalized_pdf_gauss"]


def unnormalized_log_pdf_gauss(x, mu, inv_sigma):
    """``-(x - mu)^T inv_sigma (x - mu) / 2`` of one point ``x (D,)``."""
    diff = x - mu
    return -0.5 * (diff @ inv_sigma @ diff)


def normalized_pdf_gauss(x, mu, inv_sigma):
    """The Gaussian density of mean ``mu`` and precision ``inv_sigma`` at
    ``x``."""
    _, log_det_inv = torch.linalg.slogdet(inv_sigma)
    return torch.exp(unnormalized_log_pdf_gauss(x, mu, inv_sigma)
                     - 0.5 * len(mu) * math.log(2.0 * math.pi) + 0.5 * log_det_inv)
