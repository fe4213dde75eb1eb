"""Gaussian-mixture merge fixpoint for 3-D maps (x, y, tree diameter): CUDA
kernel wrapper and its plain PyTorch twin.

Port of the JAX package's Pallas kernel ``ops/pallas/merge3d.py``.  The
kernel (``csrc/merge3d.cu``) runs the whole pass loop per particle in one
CTA; the twin is :func:`rfs_slam_tpu_torch.ops.gm.merge_fixpoint`, which
is D-generic.  Two forms, chosen by :func:`launch_plan` from the shape, as
``merge2d``'s: the small form (N <= 1,024: one thread per slot, fields and
the gate bit mask of ``csrc/merge_bitmask.cuh`` in shared memory) and the
large form (any N above: the same rules and arithmetic with a pair search
that needs no mask, two rows a warp; the gate fields, claims and bits in
shared memory up to 5,756 slots, past that in a global workspace the
wrapper allocates on the launch's stream).

:func:`merge3d` launches the kernel for CUDA tensors and runs the twin for
CPU tensors; nothing falls back.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from rfs_slam_tpu_torch.core.state import GMState
from rfs_slam_tpu_torch.ops import gm as gm_ops
from rfs_slam_tpu_torch.ops.kernels import build

SMALL_SLOTS = 1024  # the small form: one thread per slot
SLOT_PLANES = 19   # per-slot words of the fields and the claims
FIELD_BYTES = 36   # the large form's gate fields a slot: two float4, a float
# 32 warps for the gate rows: at Victoria Park's P=100 one CTA an SM fits
# every particle in one wave, and 32 warps ran the kernel ~8% faster
# than 16 on an H100 (PERF.md, section 6)
THREADS = 1024

# kernel launches made by merge3d (the twin does not count), and those of
# them in the large form
launches = 0
large_launches = 0


def merge3d_plain(gm: GMState, threshold, f_inflation,
                  max_passes: int = 8) -> GMState:
    """The plain twin: the pass-until-fixpoint loop of ops/gm.py."""
    return gm_ops.merge_fixpoint(gm, threshold, f_inflation, max_passes)


class LaunchPlan(NamedTuple):
    threads: int   # a multiple of 32, at least N in the small form
    smem: int      # dynamic shared memory bytes
    form: str = "small"   # "small" or "large"
    workspace: int = 0    # global workspace bytes (the large form)


def launch_plan(P: int, N: int) -> LaunchPlan:
    """The kernel's launch configuration, one CTA per particle of 32
    warps.  The small form (N <= ``SMALL_SLOTS``), one thread per slot:
    shared memory holds 19 slot planes (9 of gate fields, 6 of
    covariances, w, w_prev, alive and the claims), the gate bit mask (N
    rows of ceil(N / 32) words) and the safe-absorber words, as
    ``csrc/merge3d.cu`` lays it out.  The large form (N above): the
    threads stride over the slots, and there is no mask.  Shared memory
    holds a 16-byte header, the gate fields (``FIELD_BYTES`` a slot), the
    claims (4 bytes a slot), the alive bits, the safe bits and the list of
    safe words (12 bytes per 32 slots) while they fit, up to 5,756 slots
    (82,704 bytes at N=2,048); past that the gate fields, and past 53,125
    slots the claims, bits and list too, go to a global workspace
    (:func:`build.merge_large_layout`).  The output buffer holds the
    covariances and weights.  Raises ``ValueError`` for a shape neither
    form takes: the shapes of the mask forms (N * ceil(N / 32) < 2**31),
    not empty."""
    words = -(-N // 32)
    if P < 1 or N < 1 or N * words >= 2**31:
        raise ValueError(f"merge3d: no launch for P={P}, N={N}")
    if N > SMALL_SLOTS:
        smem, ws = build.merge_large_layout(P, N, FIELD_BYTES)
        return LaunchPlan(THREADS, smem, "large", ws)
    layout = 4 * (SLOT_PLANES * N + N * words + words)
    if layout > build.MAX_SMEM:
        raise ValueError(f"merge3d: N={N} needs {layout} B of shared memory")
    return LaunchPlan(THREADS, layout)


def _lib():
    lib = build.load("merge3d")
    if lib.merge3d_launch.argtypes is None:
        lib.merge3d_launch.argtypes = (
            [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_float,
                                  ctypes.c_int] + [ctypes.c_void_p] * 8
            + [ctypes.c_size_t, ctypes.c_void_p])
        lib.merge3d_launch.restype = ctypes.c_int
    return lib


def merge3d(gm: GMState, threshold, f_inflation,
            max_passes: int = 8) -> GMState:
    """Merge fixpoint of a D=3 mixture whose slots are compacted (alive
    first, by descending weight; see ops/gm.py:merge).  The CUDA kernel for
    CUDA tensors (the form :func:`launch_plan` picks from N), the plain
    twin for CPU tensors."""
    if gm.dim != 3:
        raise ValueError(f"merge3d: D={gm.dim}, needs 3-D landmarks")
    if not gm.w.is_cuda:
        return merge3d_plain(gm, threshold, f_inflation, max_passes)
    global launches, large_launches
    P, N = gm.w.shape
    plan = launch_plan(P, N)
    dev = gm.w.device
    mean = build.checked(gm.mean, torch.float32, dev, (3, P, N))
    cov = build.checked(gm.cov, torch.float32, dev, (6, P, N))
    w = build.checked(gm.w, torch.float32, dev, (P, N))
    wp = build.checked(gm.w_prev, torch.float32, dev, (P, N))
    alive = build.checked(gm.alive, torch.bool, dev, (P, N))
    # the float outputs in one buffer: mean x/y/d, cov 00/01/02/11/12/22,
    # w, w_prev
    out = torch.empty((11, P, N), dtype=torch.float32, device=dev)
    alive_o = torch.empty_like(alive)
    ws = build.workspace(plan.workspace, dev)
    err = _lib().merge3d_launch(
        P, N, plan.threads, plan.smem,
        float(threshold) * float(threshold), float(f_inflation),
        int(max_passes),
        *(t.data_ptr() for t in (mean, cov, w, wp, alive, out, alive_o)),
        build.ptr(ws), plan.workspace, build.stream_of(w))
    if err != 0:
        raise RuntimeError(f"merge3d launch failed: CUDA error {err}")
    launches += 1
    large_launches += plan.form == "large"
    return GMState(mean=out[0:3], cov=out[3:9], w=out[9], w_prev=out[10],
                   alive=alive_o)
