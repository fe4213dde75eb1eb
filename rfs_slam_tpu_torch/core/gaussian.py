"""Gaussian constants and the small dense helpers the RB-PHD step needs.

Port of the JAX package's ``core/gaussian.py`` (the reference's RandomVec,
RandomVec.hpp:64-525), cut to what the main path uses.
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


def chol2(S: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of one 2x2 SPD matrix, in closed form."""
    l00 = torch.sqrt(S[0, 0])
    l10 = S[1, 0] / l00
    l11 = torch.sqrt(torch.clamp(S[1, 1] - l10 * l10, min=0.0))
    z = torch.zeros_like(l00)
    return torch.stack([torch.stack([l00, z]), torch.stack([l10, l11])])


def sample(mean: torch.Tensor, cov: torch.Tensor,
           noise: torch.Tensor) -> torch.Tensor:
    """``mean + chol(cov) @ noise`` for one 2x2 or 3x3 ``cov`` shared by the
    batch ``mean[..., D]``, with the standard-normal draws ``noise[..., D]``
    injected (RandomVec.hpp:457-496)."""
    L = chol2(cov) if cov.shape[-1] == 2 else chol3(cov)
    return mean + noise @ L.T


def chol3(S: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of one 3x3 SPD matrix, in closed form (the
    reference's RandomVec sampling factor, RandomVec.hpp:457-496)."""
    l00 = torch.sqrt(S[0, 0])
    l10 = S[1, 0] / l00
    l20 = S[2, 0] / l00
    l11 = torch.sqrt(torch.clamp(S[1, 1] - l10 * l10, min=0.0))
    l21 = (S[2, 1] - l20 * l10) / l11
    l22 = torch.sqrt(torch.clamp(S[2, 2] - l20 * l20 - l21 * l21, min=0.0))
    z = torch.zeros_like(l00)
    return torch.stack([torch.stack([l00, z, z]),
                        torch.stack([l10, l11, z]),
                        torch.stack([l20, l21, l22])])
