"""The 2-D map-update head's plain PyTorch twin, frozen from the port's
``ops/kernels/map_update2d.py`` (the kernel wrapper, the block form and
its twins left out): the reference computes the head with these formulas
on whatever device its tensors are on."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .ekf import InnovationGates, correct_all
from .measurement import RangeBearing


class FusedMapUpdate(NamedTuple):
    """Plane-sized outputs.  ``cand_w``/``cand_m`` are ``[P, T * Zc]`` in
    (t-major, z-minor) order."""

    w: torch.Tensor          # [P, M] missed-detection-updated weights
    w_prev: torch.Tensor     # [P, M]
    pd: torch.Tensor         # [P, M]
    col_sum: torch.Tensor    # [P, Zc] clutter + table column sums
    unused: torch.Tensor     # [P, Zc] bool
    cand_w: torch.Tensor     # [P, T * Zc]
    cand_m: torch.Tensor     # [P, T * Zc] int64
    K: torch.Tensor          # [4, P, M] gain planes (row-major 2x2)
    cov_upd: torch.Tensor    # [3, P, M] packed updated covariance
    z_exp: torch.Tensor      # [2, P, M] expected (range, bearing)


def pack_params(meas: RangeBearing, gates: InnovationGates,
                md_threshold: float, birth_w: float) -> tuple:
    """The kernel's 12 scalars, rounded to float32 as the kernel sees them:
    (r_max, r_min, r_buf, pd, clutter, R00, R01, R11, md_t^2, birth_w,
    range gate, bearing gate)."""
    R = meas.R.detach().cpu().double()
    vals = (meas.r_max, meas.r_min, meas.r_buf, meas.pd_const, meas.clutter,
            R[0, 0], R[0, 1], R[1, 1], md_threshold * md_threshold, birth_w,
            gates.thresholds[0], gates.thresholds[1])
    return tuple(float(np.float32(float(v))) for v in vals)


def _plain_table(pose, mx, my, c00, c01, c11, w, alive, z, z_mask, params):
    """The twin's head: Pd, the EKF quantities and the gated, not yet
    normalised ``[P, Zc, M]`` weight table.  Returns ``(pd, close, corr,
    w_tab)``."""
    (r_max, r_min, r_buf, pd_const, clutter, R00, R01, R11, md_t2, birth_w,
     t_r, t_b) = params
    R = torch.tensor([[R00, R01], [R01, R11]], dtype=w.dtype,
                     device=w.device)
    meas = RangeBearing(R=R, pd_const=pd_const, clutter=clutter,
                        r_max=r_max, r_min=r_min, r_buf=r_buf)
    gates = InnovationGates(thresholds=(t_r, t_b), wrap_dims=(1,))
    mean = torch.stack([mx, my])
    cov = torch.stack([c00, c01, c11])
    zero = torch.zeros((), dtype=w.dtype, device=w.device)

    pd_raw, close = meas.pd_p(pose[:, None, :], mean)
    pd_raw = torch.where(alive, pd_raw, zero)
    close = close & alive
    pd = torch.where(close, torch.ones_like(pd_raw), pd_raw)

    corr = correct_all(meas, gates, pose, mean, cov, z)
    cell = (alive[:, None, :] & (pd[:, None, :] > 0.0) & z_mask[None, :, None]
            & (corr.md2 <= md_t2) & (corr.likelihood > 0.0))
    w_tab = torch.where(cell, pd[:, None, :] * w[:, None, :]
                        * corr.likelihood, zero)
    return pd, close, corr, w_tab


def _plain_tail(w, alive, pd, close, w_tab, col_sum, z_mask, birth_w,
                new_per_z):
    """The twin's tail given the column sums: the normalised table, the
    missed-detection weights, the unused flags and the top ``new_per_z``
    per column.  Returns ``(w,
    unused, cand_w, cand_m)``."""
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    w_tab = torch.where(z_mask[None, :, None], w_tab / col_sum[:, :, None],
                        zero)

    w_miss = (1.0 - pd) * w
    delta = pd * w - w_tab.sum(dim=1)
    comp = close & (w > birth_w) & (delta > 0.0)
    w_miss = torch.where(comp, torch.clamp(w_miss + delta, max=1.0), w_miss)
    unused = z_mask[None, :] & ~(w_tab > 0.0).any(dim=2)

    # per-measurement iterated first-argmax, zeroing each pick
    v = w_tab
    vals, idxs = [], []
    for _ in range(new_per_z):
        vmax, am = v.max(dim=2)
        vals.append(vmax)
        idxs.append(am)
        v = v.scatter(2, am[:, :, None], 0.0)
    return (torch.where(alive, w_miss, w), unused, torch.cat(vals, dim=1),
            torch.cat(idxs, dim=1))


def map_update2d_plain(pose, mx, my, c00, c01, c11, w, w_prev, alive, z,
                       z_mask, params, new_per_z: int = 8) -> FusedMapUpdate:
    """The plain PyTorch twin: the JAX package's XLA formulas
    (filters/rbphd.py:_map_update head) on any device."""
    pd, close, corr, w_tab = _plain_table(pose, mx, my, c00, c01, c11, w,
                                          alive, z, z_mask, params)
    col_sum = params[4] + w_tab.sum(dim=2)                      # [P, Zc]
    w_o, unused, cand_w, cand_m = _plain_tail(
        w, alive, pd, close, w_tab, col_sum, z_mask, params[9], new_per_z)
    return FusedMapUpdate(
        w=w_o, w_prev=torch.where(alive, w, w_prev),
        pd=pd, col_sum=col_sum, unused=unused, cand_w=cand_w, cand_m=cand_m,
        K=corr.K, cov_upd=corr.cov_upd, z_exp=corr.z_exp,
    )
