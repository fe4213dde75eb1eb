"""OSPA and COLA set-error metrics (port of the JAX package's
``ops/ospa.py``; OSPA.hpp:56-250, COLA.hpp:45-103).

The cost matrix is the pairwise Euclidean distance clipped at the cutoff
``c``, padded square with ``c`` for the cardinality mismatch and matched
optimally with :func:`rfs_slam_tpu_torch.ops.assignment.hungarian`::

    OSPA = ( sum_i C[i, pi(i)]^p / n )^(1/p),   n = max(|X|, |Y|)
    COLA = OSPA * n^(1/p) / c

``loc`` and ``card`` split the error into its localization (matched pairs
below the cutoff) and cardinality (assignments at the cutoff) parts, as
``OSPA::calcError`` does (OSPA.hpp:179-199).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rfs_slam_tpu_torch.ops.assignment import hungarian


class SetError(NamedTuple):
    ospa: torch.Tensor
    cola: torch.Tensor
    loc: torch.Tensor    # sum of matched sub-cutoff distances
    card: torch.Tensor   # sum of cutoff-valued assignments


def ospa(x: torch.Tensor, x_mask: torch.Tensor, y: torch.Tensor,
         y_mask: torch.Tensor, cutoff: float, order: float = 1.0) -> SetError:
    """OSPA/COLA between two padded point sets ``x [Nx, D]`` (mask
    ``[Nx]``) and ``y [Ny, D]`` (mask ``[Ny]``), on a fixed ``Nx + Ny``
    square in which the masked-out entries act as cardinality padding."""
    nx, ny = x_mask.sum(), y_mask.sum()
    n = torch.maximum(nx, ny)
    N = x.shape[0] + y.shape[0]
    d = torch.linalg.norm(x[:, None, :] - y[None, :, :], dim=-1)
    d = torch.where(x_mask[:, None] & y_mask[None, :],
                    torch.clamp(d, max=cutoff), cutoff)
    C = torch.full((N, N), cutoff, dtype=d.dtype, device=d.device)
    C[:x.shape[0], :y.shape[0]] = d
    sol, _ = hungarian(-C)         # hungarian maximizes
    picked = C[torch.arange(N, device=C.device), sol]
    # rows past n are cutoff-cutoff pairs: subtract them
    surplus = (N - n).to(d.dtype)
    total_p = torch.sum(picked ** order) - surplus * cutoff ** order
    n1 = torch.clamp(n, min=1).to(d.dtype)
    cost = torch.where(n == 0, 0.0, (total_p / n1) ** (1.0 / order))
    at_cut = picked >= cutoff - 1e-12
    loc = torch.where(at_cut, 0.0, picked).sum()
    card = torch.where(at_cut, picked, 0.0).sum() - surplus * cutoff
    cola = torch.where(n == 0, 0.0, cost * n1 ** (1.0 / order) / cutoff)
    return SetError(ospa=cost, cola=cola, loc=loc, card=card)
