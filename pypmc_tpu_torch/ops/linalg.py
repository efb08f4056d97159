"""Batched linear algebra on stacked ``(..., D, D)`` matrices.

Counterpart of :mod:`pypmc_tpu.ops.linalg` (the reference's
``pypmc/tools/_linalg.pyx``).  Where the reference raises
``numpy.linalg.LinAlgError`` for a covariance that is not symmetric
positive-definite, :func:`chol_inv_det` returns an explicit ``valid`` mask
that callers use to keep old parameters and zero the weight of dead
components.
"""

from typing import NamedTuple

import torch

__all__ = ["bilinear_sym", "chol_inv_det", "CholResult", "symmetrize"]


class CholResult(NamedTuple):
    """Result of :func:`chol_inv_det` on a stack of symmetric matrices."""

    chol: torch.Tensor      #: (..., D, D) lower L with M = L L^T (NaN where invalid)
    inv_chol: torch.Tensor  #: (..., D, D) U = L^{-1} (lower triangular)
    inv: torch.Tensor       #: (..., D, D) M^{-1} = U^T U
    log_det: torch.Tensor   #: (...,) log det M
    valid: torch.Tensor     #: (...,) bool; True where M was symmetric PD


def symmetrize(m):
    """Return the symmetric part ``(M + M^T) / 2`` of ``(..., D, D)``."""
    return 0.5 * (m + m.transpose(-1, -2))


def bilinear_sym(matrix, vector):
    """Batched symmetric bilinear form ``x^T M x``, broadcasting over the
    leading dimensions of ``matrix (..., D, D)`` and ``vector (..., D)``."""
    return torch.einsum("...i,...ij,...j->...", vector, matrix, vector)


def chol_inv_det(m) -> CholResult:
    """Batched Cholesky + inverse + log-determinant with validity mask.

    ``valid`` comes from the factorization's own ``info == 0`` (on CUDA
    ``cholesky_ex`` does not reliably leave NaN in the factor of a matrix
    that is not positive definite), together with finite input and a
    finite log-determinant.  Only the lower triangle of ``m`` is read.
    """
    d = m.shape[-1]
    chol, info = torch.linalg.cholesky_ex(m)
    valid = (info == 0) & torch.isfinite(m).all(dim=-1).all(dim=-1)
    eye = torch.eye(d, dtype=m.dtype, device=m.device)
    # substitute the identity for invalid members so nothing downstream
    # divides by a broken factor; the results there are masked by ``valid``
    safe_chol = torch.where(valid[..., None, None], chol, eye)
    inv_chol = torch.linalg.solve_triangular(
        safe_chol, eye.expand_as(safe_chol), upper=False)
    inv = inv_chol.transpose(-1, -2) @ inv_chol          # U^T U
    diag = torch.diagonal(safe_chol, dim1=-2, dim2=-1)
    log_det = 2.0 * torch.sum(torch.log(diag), dim=-1)
    valid = valid & torch.isfinite(log_det)
    chol = torch.where(valid[..., None, None], chol,
                       torch.full_like(chol, float("nan")))
    return CholResult(chol=chol, inv_chol=inv_chol, inv=inv, log_det=log_det,
                      valid=valid)
