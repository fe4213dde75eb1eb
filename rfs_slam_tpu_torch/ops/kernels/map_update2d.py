"""Fused RB-PHD map update for 2-D range-bearing SLAM: CUDA kernel wrapper
and its plain PyTorch twin.

Port of the JAX package's Pallas kernel ``ops/pallas/map_update2d.py``.  The
kernel (``csrc/map_update2d.cu``) computes the whole map-update head per
particle in one CTA and emits only plane-sized results; the ``[Zc, M]``
weight table stays in shared memory (in chunks of columns at large M; see
:func:`launch_plan`).  Two forms, chosen from the shape: the small form
(M <= 1,024: a slot's table and pick bits in a lane's 32-bit words) and
the large form (any M above: phases 2-4 over a list of the slots that can
hold a nonzero cell, interleaved by lane, the table ``[Zc, entries]``, the
stash of those slots only, in a global workspace where it does not fit
beside the table), with the same statements of arithmetic and the same
summation order.  The exact top-k over the ``Zc * T`` survivors, the ``m +
K nu`` reconstruction and ``replace_weakest`` stay in plain PyTorch
(``filters/rbphd.py``), as they stay in XLA in the JAX package.

:func:`fused_map_update2d` launches the kernel for CUDA tensors and runs
:func:`map_update2d_plain` for CPU tensors; nothing falls back.

The block form (the particles x map mesh, ``parallel/mesh.py``) runs the
update on a block of the slot axis.  The column sums span every slot, so
it is two launches: :func:`map_update2d_head` (the plane outputs and the
block's column sums without clutter) and :func:`map_update2d_tail` (given
the global column sums: the block's ``w``, unused flags and top T, as
global slot numbers).  :func:`combine_col_sums` adds the blocks' sums in
block order and :func:`merge_block_picks` takes the global top T of the
blocks' picks by the kernel's rule; :func:`map_update2d_block` runs the
four over the ranks of a map group and :func:`map_update2d_blocks` over
blocks in one process.  Each has a twin on CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from rfs_slam_tpu_torch.core import planar
from rfs_slam_tpu_torch.models.measurement import RangeBearing
from rfs_slam_tpu_torch.ops.ekf import InnovationGates, correct_all
from rfs_slam_tpu_torch.ops.kernels import build

N_PARAMS = 12
SMALL_SLOTS = 1024   # the small form: a lane's slot bits in one word
MAX_THREADS = 512    # 16 warps: two CTAs an SM (the kernel's launch bounds)
SLOT_PLANES = 10     # per-slot words of the kernel's stash
TABLE_BYTES = 96 * 1024  # the weight-table chunk's shared memory
LARGE_PLANES = 11    # the large form's stash words per table slot
# the large form's shared memory where two CTAs share an SM (228 KB less
# 1 KB a CTA); where each CTA has an SM of its own (no more particles than
# the card's SMs) it takes Hopper's whole opt-in limit
LARGE_SMEM = 113 * 1024

# kernel launches made by fused_map_update2d and the block form's head and
# tail (the twin does not count), and those of them in the large form
launches = 0
large_launches = 0


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


class MapUpdateHead(NamedTuple):
    """The block form's first launch on a block of slots: the plane
    outputs but ``w``, and the block's column sums without clutter."""

    w_prev: torch.Tensor     # [P, M]
    pd: torch.Tensor         # [P, M]
    K: torch.Tensor          # [4, P, M]
    cov_upd: torch.Tensor    # [3, P, M]
    z_exp: torch.Tensor      # [2, P, M]
    col_part: torch.Tensor   # [P, Zc] the block's table column sums


class MapUpdateTail(NamedTuple):
    """The block form's second launch: the block's share given the global
    column sums.  ``cand_m`` holds global slot numbers."""

    w: torch.Tensor          # [P, M]
    unused: torch.Tensor     # [P, Zc] no positive cell in the block
    cand_w: torch.Tensor     # [P, T * Zc] the block's top T per column
    cand_m: torch.Tensor     # [P, T * Zc] int64


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
                new_per_z, m_offset: int = 0):
    """The twin's tail given the column sums: the normalised table, the
    missed-detection weights, the unused flags and the top ``new_per_z``
    per column (slot numbers offset by ``m_offset``).  Returns ``(w,
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
    cand_m = torch.cat(idxs, dim=1)
    return (torch.where(alive, w_miss, w), unused, torch.cat(vals, dim=1),
            cand_m + m_offset if m_offset else cand_m)


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


def map_update2d_head_plain(pose, mx, my, c00, c01, c11, w, w_prev, alive,
                            z, z_mask, params) -> MapUpdateHead:
    """The twin of the block form's head (:func:`map_update2d_head`)."""
    pd, _, corr, w_tab = _plain_table(pose, mx, my, c00, c01, c11, w, alive,
                                      z, z_mask, params)
    return MapUpdateHead(w_prev=torch.where(alive, w, w_prev), pd=pd,
                         K=corr.K, cov_upd=corr.cov_upd, z_exp=corr.z_exp,
                         col_part=w_tab.sum(dim=2))


def map_update2d_tail_plain(pose, mx, my, c00, c01, c11, w, alive, z,
                            z_mask, params, col_sum, new_per_z: int = 8,
                            m_offset: int = 0) -> MapUpdateTail:
    """The twin of the block form's tail (:func:`map_update2d_tail`)."""
    pd, close, _, w_tab = _plain_table(pose, mx, my, c00, c01, c11, w,
                                       alive, z, z_mask, params)
    return MapUpdateTail(*_plain_tail(w, alive, pd, close, w_tab, col_sum,
                                      z_mask, params[9], new_per_z,
                                      m_offset))


class LaunchPlan(NamedTuple):
    threads: int   # a multiple of 32, at most MAX_THREADS
    smem: int      # dynamic shared memory bytes
    zb: int        # table columns held in shared memory at a time
    form: str = "small"   # "small" or "large"
    workspace: int = 0    # global bytes of the large form's stash (or 0)


def launch_plan(P: int, M: int, Zc: int, T: int,
                sms: int = 0) -> LaunchPlan:
    """The kernel's launch configuration, one CTA per particle.

    The small form (M <= ``SMALL_SLOTS``): shared memory holds z and its
    mask (3 words a measurement), the ``SLOT_PLANES`` per-slot planes (the
    stash), a bit word per 32 slots and a chunk of ``zb`` table columns
    (all ``Zc`` at bench shape; fewer at large M, so that the chunk stays
    within ``TABLE_BYTES``), as ``csrc/map_update2d.cu`` lays it out.  One
    warp per slot word or per column of the chunk, at most 16.

    The large form (M above): 16 warps; shared memory holds z, its mask
    and each column's entry outside the table (4 words a measurement), two
    bit words per 32 slots and a count per thread, then the list of the
    table's slots, interleaved by lane (32 times the most a lane holds,
    at most M32 = 32 * ceil(M / 32) entries): their stash
    (``LARGE_PLANES`` words each) and the table ``[zb, entries]``.  The
    kernel takes ``zb`` from the list it finds; the plan sizes shared
    memory for M32 entries: ``LARGE_SMEM`` (two CTAs an SM), or Hopper's
    limit at ``sms`` particles or fewer (``sms``: the card's SMs,
    :func:`build.sm_count`; 0 where no card is known, as on the CPU), and
    no more than the whole table with its stash needs.  Where the stash of
    M32 entries and a column do not fit, the stash goes to a global
    workspace of ``4 * LARGE_PLANES * P * M32`` bytes, used by a CTA whose
    list leaves too little room for the whole table beside its stash.  The
    plan's ``zb`` is the chunk at M32 entries.  Raises ``ValueError`` for a
    shape neither form takes (one table column and the bits past shared
    memory).
    """
    if P < 1 or M < 1 or Zc < 0 or T < 0:
        raise ValueError(f"map_update2d: no launch for P={P}, M={M}, "
                         f"Zc={Zc}, T={T}")
    words = -(-M // 32)
    if M <= SMALL_SLOTS:
        zb = max(1, min(Zc, TABLE_BYTES // (4 * M)))
        warps = min(MAX_THREADS // 32, max(words, zb))
        fixed = 3 * Zc + words + zb * M     # z, table bits, table chunk
        plan = LaunchPlan(32 * warps, 4 * (fixed + SLOT_PLANES * M), zb)
    else:
        fixed = 4 * Zc + 2 * words + MAX_THREADS   # large_fixed_words
        budget = build.MAX_SMEM if P <= sms else LARGE_SMEM
        n = 32 * words                             # the list's most entries
        whole = fixed + (LARGE_PLANES + Zc) * n    # and the table, one chunk
        if 4 * (fixed + (LARGE_PLANES + 1) * n) <= budget:
            smem = min(budget, 4 * max(whole, fixed + 12 * n))
            zb = (smem // 4 - fixed - LARGE_PLANES * n) // n
            plan = LaunchPlan(MAX_THREADS, smem, max(1, min(Zc, zb)),
                              "large")
        else:
            smem = max(4 * (fixed + n), min(budget, 4 * (fixed + Zc * n)))
            plan = LaunchPlan(MAX_THREADS, smem,
                              max(1, min(Zc, (smem // 4 - fixed) // n)),
                              "large", 4 * LARGE_PLANES * P * n)
    if plan.smem > build.MAX_SMEM:
        raise ValueError(f"map_update2d: M={M}, Zc={Zc} needs {plan.smem} B "
                         f"of shared memory, more than {build.MAX_SMEM}")
    return plan


def _lib():
    lib = build.load("map_update2d")
    if lib.map_update2d_launch.argtypes is None:
        lib.map_update2d_launch.argtypes = (
            [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_float)]
            + [ctypes.c_void_p] * 17)
        lib.map_update2d_launch.restype = ctypes.c_int
    return lib


def _plan_args(plan: LaunchPlan) -> tuple:
    """The plan as the C entries take it: threads, smem, zb (the form
    follows from M)."""
    return plan.threads, plan.smem, plan.zb


@functools.lru_cache(maxsize=8)
def _c_params(params: tuple):
    """The 12 scalars as the C array the launch takes, built once per
    params tuple (the filter packs its tuple once)."""
    return (ctypes.c_float * N_PARAMS)(*params)


def fused_map_update2d(pose, mx, my, c00, c01, c11, w, w_prev, alive, z,
                       z_mask, params, new_per_z: int = 8,
                       stats=None) -> FusedMapUpdate:
    """Run the map-update head: the CUDA kernel for CUDA tensors, the plain
    twin for CPU tensors.

    pose [P, 3]; mx..w_prev [P, M] float32; alive [P, M] bool; z [Zc, 2];
    z_mask [Zc] bool; ``params`` from :func:`pack_params`.  ``stats``: an
    int32 tensor of 3 zeros on the card, or None; the large form writes
    into it the largest count of a particle's table slots, the particles
    whose stash went to the workspace and the most table chunks of one.
    """
    if not pose.is_cuda:
        return map_update2d_plain(pose, mx, my, c00, c01, c11, w, w_prev,
                                  alive, z, z_mask, params, new_per_z)
    global launches, large_launches
    P, M = w.shape
    Zc = z.shape[0]
    T = new_per_z
    plan = launch_plan(P, M, Zc, T, build.sm_count(pose.device))
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
    stash = build.workspace(plan.workspace, dev)
    err = _lib().map_update2d_launch(
        P, M, Zc, T, *_plan_args(plan), _c_params(tuple(params)),
        *(t.data_ptr() for t in (*floats[:8], alive, floats[8], z_mask, out,
                                 un_o, cm_o)),
        build.ptr(stash), build.ptr(stats), build.stream_of(pose))
    if err != 0:
        raise RuntimeError(f"map_update2d launch failed: CUDA error {err}")
    launches += 1
    large_launches += plan.form == "large"
    return FusedMapUpdate(w=planes[0], w_prev=planes[1], pd=planes[2],
                          col_sum=cs_o, unused=un_o, cand_w=cw_o,
                          cand_m=cm_o, K=planes[3:7], cov_upd=planes[7:10],
                          z_exp=planes[10:12])


def _block_inputs(pose, mx, my, c00, c01, c11, w, w_prev, alive, z, z_mask,
                  params, T):
    """The launch plan and the checked inputs of a block-form launch."""
    P, M = w.shape
    Zc = z.shape[0]
    plan = launch_plan(P, M, Zc, T, build.sm_count(pose.device))
    if len(params) != N_PARAMS:
        raise ValueError(f"map_update2d: {len(params)} params, "
                         f"need {N_PARAMS}")
    floats = [build.checked(t, torch.float32, pose.device, shape)
              for t, shape in ((pose, (P, 3)), (mx, (P, M)), (my, (P, M)),
                               (c00, (P, M)), (c01, (P, M)), (c11, (P, M)),
                               (w, (P, M)), (w_prev, (P, M)), (z, (Zc, 2)))]
    alive = build.checked(alive, torch.bool, pose.device, (P, M))
    z_mask = build.checked(z_mask, torch.bool, pose.device, (Zc,))
    return plan, (*floats[:8], alive, floats[8], z_mask)


def _block_launch(tail, plan, params, m_offset, col_sum, ins, out, unused,
                  cand_m, pose, shape):
    global launches, large_launches
    P, M, Zc, T = shape
    lib = build.load("map_update2d")
    if lib.map_update2d_block_launch.argtypes is None:
        lib.map_update2d_block_launch.argtypes = (
            [ctypes.c_int] * 9 + [ctypes.POINTER(ctypes.c_float)]
            + [ctypes.c_void_p] * 17)
        lib.map_update2d_block_launch.restype = ctypes.c_int
    stash = build.workspace(plan.workspace, pose.device)
    err = lib.map_update2d_block_launch(
        int(tail), P, M, Zc, T, *_plan_args(plan), int(m_offset),
        _c_params(tuple(params)), build.ptr(col_sum),
        *(t.data_ptr() for t in ins), out.data_ptr(), build.ptr(unused),
        build.ptr(cand_m), build.ptr(stash), build.stream_of(pose))
    if err != 0:
        raise RuntimeError(f"map_update2d block launch failed: CUDA error "
                           f"{err}")
    launches += 1
    large_launches += plan.form == "large"


def map_update2d_head(pose, mx, my, c00, c01, c11, w, w_prev, alive, z,
                      z_mask, params) -> MapUpdateHead:
    """The block form's first launch on a block of slots (``mx`` .. ``alive``
    ``[P, M_block]``): the plane outputs but ``w`` and the block's column
    sums without the clutter, in the kernel's order.  The kernel for CUDA
    tensors, :func:`map_update2d_head_plain` for CPU tensors."""
    if not pose.is_cuda:
        return map_update2d_head_plain(pose, mx, my, c00, c01, c11, w,
                                       w_prev, alive, z, z_mask, params)
    P, M = w.shape
    Zc = z.shape[0]
    plan, ins = _block_inputs(pose, mx, my, c00, c01, c11, w, w_prev, alive,
                              z, z_mask, params, 0)
    n = P * M
    out = torch.empty(12 * n + P * Zc, dtype=torch.float32,
                      device=pose.device)
    _block_launch(False, plan, params, 0, None, ins, out, None, None, pose,
                  (P, M, Zc, 0))
    planes = out[:12 * n].view(12, P, M)
    return MapUpdateHead(w_prev=planes[1], pd=planes[2], K=planes[3:7],
                         cov_upd=planes[7:10], z_exp=planes[10:12],
                         col_part=out[12 * n:].view(P, Zc))


def map_update2d_tail(pose, mx, my, c00, c01, c11, w, alive, z, z_mask,
                      params, col_sum, new_per_z: int = 8,
                      m_offset: int = 0) -> MapUpdateTail:
    """The block form's second launch on the block of slots ``m_offset ..
    m_offset + M_block - 1``, given the global column sums ``col_sum [P,
    Zc]`` (clutter included): the block's ``w``, unused flags and top
    ``new_per_z`` per column (global slot numbers).  The kernel for CUDA
    tensors, :func:`map_update2d_tail_plain` for CPU tensors."""
    if not pose.is_cuda:
        return map_update2d_tail_plain(pose, mx, my, c00, c01, c11, w, alive,
                                       z, z_mask, params, col_sum, new_per_z,
                                       m_offset)
    P, M = w.shape
    Zc = z.shape[0]
    T = new_per_z
    plan, ins = _block_inputs(pose, mx, my, c00, c01, c11, w, w, alive, z,
                              z_mask, params, T)
    col_sum = build.checked(col_sum, torch.float32, pose.device, (P, Zc))
    dev, n = pose.device, P * M
    out = torch.empty(n + P * Zc * T, dtype=torch.float32, device=dev)
    unused = torch.empty((P, Zc), dtype=torch.bool, device=dev)
    cand_m = torch.empty((P, T * Zc), dtype=torch.int64, device=dev)
    _block_launch(True, plan, params, m_offset, col_sum, ins, out, unused,
                  cand_m, pose, (P, M, Zc, T))
    return MapUpdateTail(w=out[:n].view(P, M), unused=unused,
                         cand_w=out[n:].view(P, T * Zc), cand_m=cand_m)


def block_sum(parts: torch.Tensor) -> torch.Tensor:
    """``parts [B, ...]`` added in block order: the same bits on every rank
    of a map group (for B = 1 the part itself)."""
    s = parts[0]
    for b in range(1, parts.shape[0]):
        s = s + parts[b]
    return s


def combine_col_sums(parts: torch.Tensor, clutter: float) -> torch.Tensor:
    """The global column sums from the blocks' ``parts [B, P, Zc]``: the
    blocks added in block order, then the clutter, as one launch adds
    ``clutter + s`` (for B = 1 the one launch's sums)."""
    return clutter + block_sum(parts)


def merge_block_picks(cand_w, cand_m, unused, T: int):
    """The global top T per column from the blocks' picks ``cand_w``,
    ``cand_m [B, P, T * Zc]`` (t-major, z-minor) and unused flags ``[B, P,
    Zc]``: value descending, the lower slot first among equals (the
    kernel's first-argmax rule; each block's picks are in that order and
    the blocks in slot order, so a stable sort of the blocks' lists in
    block order keeps it); a column is unused where no block had a
    positive cell.  Returns ``(cand_w, cand_m, unused)`` of one launch."""
    B, P, TZ = cand_w.shape
    Zc = TZ // T

    def by_column(x):                      # [P, Zc, B * T], block-major
        return x.view(B, P, T, Zc).permute(1, 3, 0, 2).reshape(P, Zc, B * T)

    vals, pos = planar.topk_stable(by_column(cand_w), T)
    idx = torch.gather(by_column(cand_m), 2, pos)
    return (vals.transpose(1, 2).reshape(P, T * Zc),
            idx.transpose(1, 2).reshape(P, T * Zc), unused.all(dim=0))


def map_update2d_block(pose, mx, my, c00, c01, c11, w, w_prev, alive, z,
                       z_mask, params, new_per_z: int, m_offset: int,
                       gather_blocks):
    """The map update of this rank's block of slots (``m_offset ..``) under
    a map group: the head launch, the blocks' column sums gathered and
    combined (:func:`combine_col_sums`: the same bits on every rank), the
    tail launch, and the blocks' picks, unused flags and in-view counts
    gathered in one collective and merged (:func:`merge_block_picks`).
    ``gather_blocks({name: x})`` returns every rank's ``x`` stacked on a
    leading axis in rank order (``MapMesh.gather_blocks``).  Returns
    ``(FusedMapUpdate, n_in_fov [P])``: the planes ``w`` .. ``z_exp`` of
    the block, ``col_sum``, ``unused`` and the picks global (the same on
    every rank of the group), and the in-view count over every slot."""
    head = map_update2d_head(pose, mx, my, c00, c01, c11, w, w_prev, alive,
                             z, z_mask, params)
    col_sum = combine_col_sums(
        gather_blocks({"col_part": head.col_part})["col_part"], params[4])
    tail = map_update2d_tail(pose, mx, my, c00, c01, c11, w, alive, z,
                             z_mask, params, col_sum, new_per_z, m_offset)
    got = gather_blocks({
        "cand_w": tail.cand_w, "cand_m": tail.cand_m, "unused": tail.unused,
        "fov": (head.pd != 0.0).sum(dim=1, dtype=torch.int32)})
    cand_w, cand_m, unused = merge_block_picks(
        got["cand_w"], got["cand_m"], got["unused"], new_per_z)
    n_in_fov = got["fov"].sum(dim=0, dtype=torch.int32)
    return FusedMapUpdate(
        w=tail.w, w_prev=head.w_prev, pd=head.pd, col_sum=col_sum,
        unused=unused, cand_w=cand_w, cand_m=cand_m, K=head.K,
        cov_upd=head.cov_upd, z_exp=head.z_exp), n_in_fov


def map_update2d_blocks(pose, mx, my, c00, c01, c11, w, w_prev, alive, z,
                        z_mask, params, new_per_z: int = 8,
                        n_blocks: int = 1,
                        plain: bool = False) -> FusedMapUpdate:
    """The block form over ``n_blocks`` equal blocks of the slot axis in one
    process (what :func:`map_update2d_block` computes over a map group of
    that many ranks), its outputs laid out as :func:`fused_map_update2d`'s:
    the head and tail of each block, the combined column sums and the
    merged picks.  ``plain``: the twins on any device."""
    head_fn = map_update2d_head_plain if plain else map_update2d_head
    tail_fn = map_update2d_tail_plain if plain else map_update2d_tail
    P, M = w.shape
    if M % n_blocks:
        raise ValueError(f"{M} slots do not split into {n_blocks} blocks")
    Mb = M // n_blocks
    slots = [tuple(x[..., b * Mb:(b + 1) * Mb]
                   for x in (mx, my, c00, c01, c11, w, w_prev, alive))
             for b in range(n_blocks)]
    heads = [head_fn(pose, *s, z, z_mask, params) for s in slots]
    col_sum = combine_col_sums(torch.stack([h.col_part for h in heads]),
                               params[4])
    tails = [tail_fn(pose, *s[:6], s[7], z, z_mask, params, col_sum,
                     new_per_z, b * Mb)
             for b, s in enumerate(slots)]
    cand_w, cand_m, unused = merge_block_picks(
        *(torch.stack([getattr(t, k) for t in tails])
          for k in ("cand_w", "cand_m", "unused")), new_per_z)

    def cat(k, dim=-1):
        return torch.cat([getattr(h, k) for h in heads], dim=dim)

    return FusedMapUpdate(
        w=torch.cat([t.w for t in tails], dim=1), w_prev=cat("w_prev"),
        pd=cat("pd"), col_sum=col_sum, unused=unused, cand_w=cand_w,
        cand_m=cand_m, K=cat("K"), cov_upd=cat("cov_upd"),
        z_exp=cat("z_exp"))
