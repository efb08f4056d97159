"""Low-level operations: batched linear algebra, log-sum-exp, chi-square
sampling, and the port's CUDA kernels (:mod:`.kernels`)."""

from . import kernels
from .linalg import CholResult, bilinear_sym, chol_inv_det, symmetrize
from .lse import logsumexp, logsumexp2D, regularize, tiny
from .random import chi2_log, chisquare, student_t_scale
