"""Fused RB-PHD map update for 2-D range-bearing SLAM: CUDA kernel wrapper
and its plain PyTorch twin.

Port of the JAX package's Pallas kernel ``ops/pallas/map_update2d.py``.  The
kernel (``csrc/map_update2d.cu``) computes the whole map-update head per
particle in one CTA and emits only plane-sized results; the ``[Zc, M]``
weight table stays in shared memory.  The exact top-k over the ``Zc * T``
survivors, the ``m + K nu`` reconstruction and ``replace_weakest`` stay in
plain PyTorch (``filters/rbphd.py``), as they stay in XLA in the JAX
package.

:func:`fused_map_update2d` launches the kernel for CUDA tensors and runs
:func:`map_update2d_plain` for CPU tensors; nothing falls back.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from rfs_slam_tpu_torch.models.measurement import RangeBearing
from rfs_slam_tpu_torch.ops.ekf import InnovationGates, correct_all
from rfs_slam_tpu_torch.ops.kernels import build

N_PARAMS = 12
MAX_SLOTS = 1024  # one thread per landmark slot

# kernel launches made by fused_map_update2d (the twin does not count)
launches = 0


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


def map_update2d_plain(pose, mx, my, c00, c01, c11, w, w_prev, alive, z,
                       z_mask, params, new_per_z: int = 8) -> FusedMapUpdate:
    """The plain PyTorch twin: the JAX package's XLA formulas
    (filters/rbphd.py:_map_update head) on any device."""
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
    col_sum = clutter + w_tab.sum(dim=2)                        # [P, Zc]
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
    return FusedMapUpdate(
        w=torch.where(alive, w_miss, w), w_prev=torch.where(alive, w, w_prev),
        pd=pd, col_sum=col_sum, unused=unused,
        cand_w=torch.cat(vals, dim=1), cand_m=torch.cat(idxs, dim=1),
        K=corr.K, cov_upd=corr.cov_upd, z_exp=corr.z_exp,
    )


def _lib():
    lib = build.load("map_update2d")
    if lib.map_update2d_launch.argtypes is None:
        lib.map_update2d_launch.argtypes = (
            [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_float)]
            + [ctypes.c_void_p] * 28)
        lib.map_update2d_launch.restype = ctypes.c_int
    return lib


def fused_map_update2d(pose, mx, my, c00, c01, c11, w, w_prev, alive, z,
                       z_mask, params, new_per_z: int = 8) -> FusedMapUpdate:
    """Run the map-update head: the CUDA kernel for CUDA tensors, the plain
    twin for CPU tensors.

    pose [P, 3]; mx..w_prev [P, M] float32; alive [P, M] bool; z [Zc, 2];
    z_mask [Zc] bool; ``params`` from :func:`pack_params`.
    """
    if not pose.is_cuda:
        return map_update2d_plain(pose, mx, my, c00, c01, c11, w, w_prev,
                                  alive, z, z_mask, params, new_per_z)
    global launches
    P, M = w.shape
    Zc = z.shape[0]
    T = new_per_z
    if M > MAX_SLOTS:
        raise ValueError(f"map_update2d: M={M} > {MAX_SLOTS} slots")
    if len(params) != N_PARAMS:
        raise ValueError(f"map_update2d: {len(params)} params, "
                         f"need {N_PARAMS}")
    floats = [build.checked(t, torch.float32, pose.device, shape)
              for t, shape in ((pose, (P, 3)), (mx, (P, M)), (my, (P, M)),
                               (c00, (P, M)), (c01, (P, M)), (c11, (P, M)),
                               (w, (P, M)), (w_prev, (P, M)), (z, (Zc, 2)))]
    alive = build.checked(alive, torch.bool, pose.device, (P, M))
    z_mask = build.checked(z_mask, torch.bool, pose.device, (Zc,))
    pose, mx, my, c00, c01, c11, w, w_prev, z = floats

    dev, f32 = pose.device, torch.float32
    w_o = torch.empty((P, M), dtype=f32, device=dev)
    wp_o = torch.empty_like(w_o)
    pd_o = torch.empty_like(w_o)
    cs_o = torch.empty((P, Zc), dtype=f32, device=dev)
    un_o = torch.empty((P, Zc), dtype=torch.bool, device=dev)
    cw_o = torch.empty((P, T * Zc), dtype=f32, device=dev)
    cm_o = torch.empty((P, T * Zc), dtype=torch.int64, device=dev)
    K = torch.empty((4, P, M), dtype=f32, device=dev)
    cu = torch.empty((3, P, M), dtype=f32, device=dev)
    ze = torch.empty((2, P, M), dtype=f32, device=dev)
    prm = (ctypes.c_float * N_PARAMS)(*params)
    err = _lib().map_update2d_launch(
        P, M, Zc, T, prm,
        *(t.data_ptr() for t in (pose, mx, my, c00, c01, c11, w, w_prev,
                                 alive, z, z_mask, w_o, wp_o, pd_o, cs_o,
                                 un_o, cw_o, cm_o, K[0], K[1], K[2], K[3],
                                 cu[0], cu[1], cu[2], ze[0], ze[1])),
        build.stream_of(pose))
    if err != 0:
        raise RuntimeError(f"map_update2d launch failed: CUDA error {err}")
    launches += 1
    return FusedMapUpdate(w=w_o, w_prev=wp_o, pd=pd_o, col_sum=cs_o,
                          unused=un_o, cand_w=cw_o, cand_m=cm_o, K=K,
                          cov_upd=cu, z_exp=ze)
