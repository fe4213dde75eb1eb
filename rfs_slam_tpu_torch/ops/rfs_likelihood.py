"""Exact RFS measurement likelihood via a subset-sum dynamic program (port
of the JAX package's ``ops/rfs_likelihood.py``; replaces the reference's
partition + Murty-200 evaluation, RBPHDFilter.hpp:821-997).

The DP runs on a flat state ``[P, 2^Zd]`` indexed by the set S of matched
columns; column c is bit ``Zd-1-c`` of S, the order of the JAX package's
``(2,) * Zd`` state.  One row step is

    new[S] = state[S] * miss_r + sum_{c in S} state[S \\ {c}] * L[r, c],

done as one gather of the ``Zd`` bit partners (precomputed indices; a
partner outside S points at a zero column) and one batched contraction, so
a row costs a few launches instead of ``Zd`` slice/concatenate pairs.
"""

from __future__ import annotations

import functools

import torch

from rfs_slam_tpu_torch.core import planar

_EPS = 1e-30


@functools.lru_cache(maxsize=None)
def _subset_tables(zd: int, device: torch.device):
    """Index tables of the DP over subsets S of ``zd`` columns, built on
    ``device`` once per (zd, device), so no step copies from the host, the
    first included:

    * ``partners`` [Zd * 2^Zd]: S \\ {c} where c is in S, else 2^Zd (the
      state's trailing zero column);
    * ``unmatched`` [Zd, 2^Zd] bool: c is not in S.
    """
    n = 1 << zd
    s = torch.arange(n, device=device)
    bits = torch.ones(zd, dtype=torch.long, device=device) << torch.arange(
        zd - 1, -1, -1, device=device)
    unmatched = (s[None, :] & bits[:, None]) == 0
    partners = torch.where(unmatched, n, s[None, :] ^ bits[:, None])
    return partners.reshape(-1), unmatched


def rfs_log_likelihood(L: torch.Tensor, pd: torch.Tensor,
                       row_active: torch.Tensor, clutter: torch.Tensor,
                       z_active: torch.Tensor, log_clutter_integral,
                       z_dp_max: int = 12) -> torch.Tensor:
    """Log RFS measurement likelihood per particle, [P].

    L [P, E, Z] gated likelihood * Pd; pd [P, E]; row_active [P, E] bool;
    clutter [P, Z] (or broadcastable); z_active [P, Z] or [Z] bool.
    """
    P, E, Z = L.shape
    zero = torch.zeros((), dtype=L.dtype, device=L.device)
    z_active = z_active.expand(P, Z)
    clutter = torch.as_tensor(clutter, dtype=L.dtype,
                              device=L.device).expand(P, Z)
    L = torch.where(row_active[:, :, None] & z_active[:, None, :], L, zero)

    # ---- keep the z_dp_max best-supported columns in the DP
    support = L.amax(dim=1)
    has_support = (support > 0.0) & z_active
    Zd = min(Z, z_dp_max)
    sel_score = torch.where(has_support, support,
                            torch.full_like(support, float("-inf")))
    _, sel_idx = planar.topk_stable(sel_score, Zd)
    sel_valid = torch.gather(has_support, 1, sel_idx)
    L_sel = torch.gather(L, 2, sel_idx[:, None, :].expand(P, E, Zd))
    L_sel = torch.where(sel_valid[:, None, :], L_sel, zero)
    clut_sel = torch.gather(clutter, 1, sel_idx)

    # active columns outside the DP contribute their clutter factor exactly
    in_dp = torch.zeros((P, Z), dtype=torch.bool, device=L.device).scatter(
        1, sel_idx, sel_valid)
    log_extra = torch.where(z_active & ~in_dp,
                            torch.log(torch.clamp(clutter, min=_EPS)),
                            zero).sum(dim=1)

    # ---- reference zero-partition quirk: support-less rows use Pd, not 1-Pd
    row_support = L_sel.amax(dim=2) > 0.0
    pd_eff = torch.where(row_support, pd, 1.0 - pd)
    miss = torch.where(row_active, 1.0 - pd_eff, torch.ones_like(pd))
    L_sel = torch.where(row_active[:, :, None], L_sel, zero)

    # ---- row scaling a_r, then column scaling b_c (underflow control)
    a = torch.clamp(torch.maximum(miss, L_sel.amax(dim=2)), min=_EPS)
    a = torch.where(row_active, a, torch.ones_like(a))
    L1 = L_sel / a[:, :, None]
    miss1 = miss / a
    b = torch.clamp(torch.maximum(clut_sel, L1.amax(dim=1)), min=_EPS)
    b = torch.where(sel_valid, b, torch.ones_like(b))
    L2 = L1 / b[:, None, :]
    clut1 = torch.where(sel_valid, clut_sel / b, torch.ones_like(b))

    # ---- subset-sum DP over the Zd selected columns
    n = 1 << Zd
    partners, unmatched = _subset_tables(Zd, L.device)
    state = torch.zeros((P, n + 1), dtype=L.dtype, device=L.device)
    state[:, 0] = 1.0
    for r in range(E):
        shifted = state[:, partners].view(P, Zd, n)
        state[:, :n] = state[:, :n] * miss1[:, r:r + 1] + torch.einsum(
            "pc,pcs->ps", L2[:, r], shifted)

    # ---- unmatched columns take their scaled clutter factor; sum subsets
    fac = torch.where(unmatched[None], clut1[:, :, None],
                      torch.ones((), dtype=L.dtype, device=L.device))
    total = (state[:, :n] * fac.prod(dim=1)).sum(dim=1)

    return (torch.log(torch.clamp(total, min=_EPS))
            + torch.log(a).sum(dim=1) + torch.log(b).sum(dim=1)
            + log_extra - log_clutter_integral)
