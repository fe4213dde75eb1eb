"""Batched Gaussian toolkit, the reference's RandomVec (RandomVec.hpp:64-525)
as pure functions over ``(..., D)`` means and ``(..., D, D)`` covariances
(port of the JAX package's ``core/gaussian.py``).

D is tiny (1-3), so determinants, inverses and Cholesky factors use the
closed forms the JAX package uses; larger D goes to ``torch.linalg``.

* ``eval_likelihood`` = exp(-md2/2) / sqrt((2 pi)^D det(S)) with the
  not-finite -> 0 guard of RandomVec.hpp:424-425;
* ``mahalanobis2`` uses the covariance inverse (RandomVec.hpp:387-407);
* ``sample`` draws mean + chol(S) @ n, n ~ N(0, I) (RandomVec.hpp:457-496),
  the standard-normal draws injected or taken from a ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch

# Linear-domain floor standing in for the reference's
# std::numeric_limits<double>::denorm_min() particle-weight floor
# (RBPHDFilter.hpp:570, 743). float32-safe.
TINY = 1e-35
# Floor for squared-range Jacobian denominators: keeps H finite for a
# landmark exactly at the sensor (dead slots + origin pose).
R2_TINY = 1e-24

TWO_PI = 2.0 * math.pi
LOG_2PI = 1.8378770664093453


def wrap_angle(a: torch.Tensor) -> torch.Tensor:
    """Wrap angles to (-pi, pi] by rounding half to even (``torch.round``),
    as ``jnp.round`` does."""
    return a - TWO_PI * torch.round(a / TWO_PI)


def matrix(rows) -> torch.Tensor:
    """``[..., R, C]`` from nested lists (rows of entries) of ``[...]``
    tensors."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def det(S: torch.Tensor) -> torch.Tensor:
    """Determinant of batched tiny matrices ``(..., D, D)``."""
    d = S.shape[-1]
    if d == 1:
        return S[..., 0, 0]
    if d == 2:
        return S[..., 0, 0] * S[..., 1, 1] - S[..., 0, 1] * S[..., 1, 0]
    if d == 3:
        a, b, c = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
        e, f, g = S[..., 1, 0], S[..., 1, 1], S[..., 1, 2]
        h, i, j = S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]
        return a * (f * j - g * i) - b * (e * j - g * h) + c * (e * i - f * h)
    return torch.linalg.det(S)


def inv(S: torch.Tensor) -> torch.Tensor:
    """Inverse of batched tiny matrices by the adjugate (D in 1..3)."""
    d = S.shape[-1]
    if d == 1:
        return 1.0 / S
    if d == 2:
        adj = matrix([[S[..., 1, 1], -S[..., 0, 1]],
                    [-S[..., 1, 0], S[..., 0, 0]]])
        return adj / det(S)[..., None, None]
    if d == 3:
        m = S
        c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
        c01 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
        c02 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
        c10 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
        c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
        c12 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
        c20 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
        c21 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
        c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
        adj = matrix([[c00, c01, c02], [c10, c11, c12], [c20, c21, c22]])
        return adj / det(S)[..., None, None]
    return torch.linalg.inv(S)


def chol(S: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of batched tiny SPD matrices (D in 1..3)."""
    d = S.shape[-1]
    if d == 1:
        return torch.sqrt(S)
    l00 = torch.sqrt(S[..., 0, 0])
    z = torch.zeros_like(l00)
    if d == 2:
        l10 = S[..., 1, 0] / l00
        l11 = torch.sqrt(torch.clamp(S[..., 1, 1] - l10 * l10, min=0.0))
        return matrix([[l00, z], [l10, l11]])
    if d == 3:
        l10 = S[..., 1, 0] / l00
        l20 = S[..., 2, 0] / l00
        l11 = torch.sqrt(torch.clamp(S[..., 1, 1] - l10 * l10, min=0.0))
        l21 = (S[..., 2, 1] - l20 * l10) / l11
        l22 = torch.sqrt(torch.clamp(S[..., 2, 2] - l20 * l20 - l21 * l21,
                                     min=0.0))
        return matrix([[l00, z, z], [l10, l11, z], [l20, l21, l22]])
    return torch.linalg.cholesky(S)


def quad_form(Sinv: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """e^T Sinv e for batched ``(..., D, D)`` and ``(..., D)``."""
    return torch.einsum("...i,...ij,...j->...", e, Sinv, e)


def mahalanobis2(mean: torch.Tensor, cov: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """Squared Mahalanobis distance of x from N(mean, cov)
    (RandomVec.hpp:387-407)."""
    return quad_form(inv(cov), x - mean)


def eval_likelihood(mean: torch.Tensor, cov: torch.Tensor, x: torch.Tensor):
    """``(pdf at x, md2)`` with the not-finite -> 0 guard
    (``RandomVec::evalGaussianLikelihood``, RandomVec.hpp:415-451)."""
    d = mean.shape[-1]
    md2 = mahalanobis2(mean, cov, x)
    norm = torch.sqrt(TWO_PI ** d * det(cov))
    lik = torch.exp(-0.5 * md2) / norm
    return torch.where(torch.isfinite(lik), lik, 0.0), md2


def log_likelihood(mean: torch.Tensor, cov: torch.Tensor, x: torch.Tensor):
    """``(log pdf at x, md2)``."""
    d = mean.shape[-1]
    md2 = mahalanobis2(mean, cov, x)
    return -0.5 * (md2 + torch.log(det(cov)) + d * LOG_2PI), md2


def sample(mean: torch.Tensor, cov: torch.Tensor,
           noise: torch.Tensor | None = None,
           gen: torch.Generator | None = None) -> torch.Tensor:
    """``mean + chol(cov) @ n`` (RandomVec.hpp:457-496) with ``n`` the
    standard-normal draws ``noise [..., D]``, or drawn from ``gen`` when
    ``noise`` is None.  ``cov`` is one ``[D, D]`` shared by the batch
    ``mean [..., D]``, or batched ``[..., D, D]``."""
    if noise is None:
        noise = torch.randn(mean.shape, generator=gen, dtype=mean.dtype,
                            device=mean.device)
    L = chol(cov)
    if cov.dim() == 2:
        return mean + noise @ L.T
    return mean + torch.einsum("...ij,...j->...i", L, noise)


def symmetrize(S: torch.Tensor) -> torch.Tensor:
    """(S + S^T) / 2, as KalmanFilter.hpp:242."""
    return 0.5 * (S + S.transpose(-1, -2))
