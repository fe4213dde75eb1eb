"""Fused RB-PHD map update for 2-D range-bearing SLAM: CUDA kernel wrapper
and its plain PyTorch twin.

Port of the JAX package's Pallas kernel ``ops/pallas/map_update2d.py``.  The
kernel (``csrc/map_update2d.cu``) computes the whole map-update head per
particle in one CTA and emits only plane-sized results; the ``[Zc, M]``
weight table stays in shared memory (in chunks of columns at large M; see
:func:`launch_plan`).  The exact top-k over the ``Zc * T``
survivors, the ``m + K nu`` reconstruction and ``replace_weakest`` stay in
plain PyTorch (``filters/rbphd.py``), as they stay in XLA in the JAX
package.

:func:`fused_map_update2d` launches the kernel for CUDA tensors and runs
:func:`map_update2d_plain` for CPU tensors; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from rfs_slam_tpu_torch.models.measurement import RangeBearing
from rfs_slam_tpu_torch.ops.ekf import InnovationGates, correct_all
from rfs_slam_tpu_torch.ops.kernels import build

N_PARAMS = 12
MAX_SLOTS = 1024
MAX_THREADS = 512    # 16 warps: two CTAs an SM (the kernel's launch bounds)
SLOT_PLANES = 10     # per-slot words the kernel keeps in shared memory
TABLE_BYTES = 96 * 1024  # the weight-table chunk's shared memory

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


class LaunchPlan(NamedTuple):
    threads: int   # a multiple of 32, at most MAX_THREADS
    smem: int      # dynamic shared memory bytes
    zb: int        # table columns held in shared memory at a time


def launch_plan(P: int, M: int, Zc: int, T: int) -> LaunchPlan:
    """The kernel's launch configuration, one CTA per particle.

    Shared memory holds z and its mask (3 words a measurement), the
    ``SLOT_PLANES`` per-slot planes, a bit word per 32 slots and a chunk of
    ``zb`` table columns (all ``Zc`` at bench shape; fewer at large M, so
    that the chunk stays within ``TABLE_BYTES``), as
    ``csrc/map_update2d.cu`` lays it out.  One warp per slot word or per
    column of the chunk, at most 16.  Raises ``ValueError`` for a shape the
    kernel does not take.
    """
    if P < 1 or not 1 <= M <= MAX_SLOTS or Zc < 0 or T < 0:
        raise ValueError(f"map_update2d: no launch for P={P}, M={M}, "
                         f"Zc={Zc}, T={T} (1 <= M <= {MAX_SLOTS})")
    zb = max(1, min(Zc, TABLE_BYTES // (4 * M)))
    warps = min(MAX_THREADS // 32, max(-(-M // 32), zb))
    smem = 4 * (3 * Zc + SLOT_PLANES * M + -(-M // 32) + zb * M)
    if smem > build.MAX_SMEM:
        raise ValueError(f"map_update2d: Zc={Zc} needs {smem} B of shared "
                         f"memory, more than {build.MAX_SMEM}")
    return LaunchPlan(32 * warps, smem, zb)


def _lib():
    lib = build.load("map_update2d")
    if lib.map_update2d_launch.argtypes is None:
        lib.map_update2d_launch.argtypes = (
            [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_float)]
            + [ctypes.c_void_p] * 15)
        lib.map_update2d_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=8)
def _c_params(params: tuple):
    """The 12 scalars as the C array the launch takes, built once per
    params tuple (the filter packs its tuple once)."""
    return (ctypes.c_float * N_PARAMS)(*params)


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
    plan = launch_plan(P, M, Zc, T)
    if len(params) != N_PARAMS:
        raise ValueError(f"map_update2d: {len(params)} params, "
                         f"need {N_PARAMS}")
    floats = [build.checked(t, torch.float32, pose.device, shape)
              for t, shape in ((pose, (P, 3)), (mx, (P, M)), (my, (P, M)),
                               (c00, (P, M)), (c01, (P, M)), (c11, (P, M)),
                               (w, (P, M)), (w_prev, (P, M)), (z, (Zc, 2)))]
    alive = build.checked(alive, torch.bool, pose.device, (P, M))
    z_mask = build.checked(z_mask, torch.bool, pose.device, (Zc,))

    # the float outputs in one buffer, laid out as the kernel writes them:
    # 12 planes [P, M], col_sum [P, Zc], cand_w [P, T * Zc]
    dev, n = pose.device, P * M
    out = torch.empty(12 * n + P * Zc * (1 + T), dtype=torch.float32,
                      device=dev)
    planes = out[:12 * n].view(12, P, M)
    cs_o = out[12 * n:12 * n + P * Zc].view(P, Zc)
    cw_o = out[12 * n + P * Zc:].view(P, T * Zc)
    un_o = torch.empty((P, Zc), dtype=torch.bool, device=dev)
    cm_o = torch.empty((P, T * Zc), dtype=torch.int64, device=dev)
    err = _lib().map_update2d_launch(
        P, M, Zc, T, *plan, _c_params(tuple(params)),
        *(t.data_ptr() for t in (*floats[:8], alive, floats[8], z_mask, out,
                                 un_o, cm_o)),
        build.stream_of(pose))
    if err != 0:
        raise RuntimeError(f"map_update2d launch failed: CUDA error {err}")
    launches += 1
    return FusedMapUpdate(w=planes[0], w_prev=planes[1], pd=planes[2],
                          col_sum=cs_o, unused=un_o, cand_w=cw_o,
                          cand_m=cm_o, K=planes[3:7], cov_upd=planes[7:10],
                          z_exp=planes[10:12])
