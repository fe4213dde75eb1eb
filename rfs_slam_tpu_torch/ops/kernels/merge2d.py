"""Gaussian-mixture merge fixpoint for 2-D maps: CUDA kernel wrapper and
its plain PyTorch twin.

Port of the JAX package's Pallas kernel ``ops/pallas/merge2d.py``.  The
kernel (``csrc/merge2d.cu``) runs the whole pass loop per particle in one
CTA; the twin is :func:`rfs_slam_tpu_torch.ops.gm.merge_fixpoint`.  Two
forms, chosen by :func:`launch_plan` from the shape: the small form (N <=
1,024: one thread per slot, fields and the gate bit mask in shared memory)
and the large form (any N above: the same rules and arithmetic with a pair
search that needs no mask, the gate fields, claims and bits in shared
memory up to 9,535 slots, past that in a global workspace the wrapper
allocates on the launch's stream).

:func:`merge2d` launches the kernel for CUDA tensors and runs the twin for
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
MIN_THREADS = 512  # 16 warps for the gate rows, two CTAs an SM
LARGE_THREADS = 1024  # the large form's threads, striding over the slots
SLOT_PLANES = 12   # per-slot words of the fields and the claims
FIELD_BYTES = 20   # a slot's gate fields: a float4 and a float

# kernel launches made by merge2d (the twin does not count), and those of
# them in the large form
launches = 0
large_launches = 0


def merge2d_plain(gm: GMState, threshold, f_inflation,
                  max_passes: int = 8) -> GMState:
    """The plain twin: the pass-until-fixpoint loop of ops/gm.py."""
    return gm_ops.merge_fixpoint(gm, threshold, f_inflation, max_passes)


class LaunchPlan(NamedTuple):
    threads: int   # a multiple of 32, at least N in the small form
    smem: int      # dynamic shared memory bytes
    form: str = "small"   # "small" or "large"
    workspace: int = 0    # global workspace bytes (the large form)


def launch_plan(P: int, N: int) -> LaunchPlan:
    """The kernel's launch configuration, one CTA per particle.

    The small form (N <= ``SMALL_SLOTS``): one thread per slot and at
    least 16 warps for the gate rows; shared memory holds 12 slot planes,
    the gate bit mask (N rows of ceil(N / 32) words) and the safe-absorber
    words, as ``csrc/merge2d.cu`` lays it out.  The large form (N above):
    ``LARGE_THREADS`` threads and no mask.  Shared memory holds a 16-byte
    header, the gate fields (``FIELD_BYTES`` a slot), the claims (4 bytes
    a slot), the alive bits, the safe bits and the list of safe words (12
    bytes per 32 slots) while they fit, up to 9,535 slots; past that the
    gate fields, and past 53,125 slots the claims, bits and list too, go to
    a global workspace (:func:`build.merge_large_layout`: ``P`` parts,
    each rounded up to 16 bytes).  The output buffer holds the covariances
    and weights.  Raises
    ``ValueError`` for a shape neither form takes: the shapes of the mask
    forms (N * ceil(N / 32) < 2**31, as ``merge3d``'s), not empty."""
    words = -(-N // 32)
    if P < 1 or N < 1 or N * words >= 2**31:
        raise ValueError(f"merge2d: no launch for P={P}, N={N}")
    if N > SMALL_SLOTS:
        smem, ws = build.merge_large_layout(P, N, FIELD_BYTES)
        return LaunchPlan(LARGE_THREADS, smem, "large", ws)
    layout = 4 * (SLOT_PLANES * N + N * words + words)
    if layout > build.MAX_SMEM:
        raise ValueError(f"merge2d: N={N} needs {layout} B of shared memory")
    return LaunchPlan(max(MIN_THREADS, 32 * words), layout)


def _lib():
    lib = build.load("merge2d")
    if lib.merge2d_launch.argtypes is None:
        lib.merge2d_launch.argtypes = (
            [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_float,
                                  ctypes.c_int] + [ctypes.c_void_p] * 8
            + [ctypes.c_size_t, ctypes.c_void_p])
        lib.merge2d_launch.restype = ctypes.c_int
    return lib


def merge2d(gm: GMState, threshold, f_inflation,
            max_passes: int = 8) -> GMState:
    """Merge fixpoint of a D=2 mixture whose slots are compacted (alive
    first, by descending weight; see ops/gm.py:merge).  The CUDA kernel for
    CUDA tensors (the form :func:`launch_plan` picks from N), the plain
    twin for CPU tensors."""
    if gm.dim != 2:
        raise ValueError(f"merge2d: D={gm.dim}, needs 2-D landmarks")
    if not gm.w.is_cuda:
        return merge2d_plain(gm, threshold, f_inflation, max_passes)
    global launches, large_launches
    P, N = gm.w.shape
    plan = launch_plan(P, N)
    dev = gm.w.device
    mean = build.checked(gm.mean, torch.float32, dev, (2, P, N))
    cov = build.checked(gm.cov, torch.float32, dev, (3, P, N))
    w = build.checked(gm.w, torch.float32, dev, (P, N))
    wp = build.checked(gm.w_prev, torch.float32, dev, (P, N))
    alive = build.checked(gm.alive, torch.bool, dev, (P, N))
    # the float outputs in one buffer: mean x/y, cov 00/01/11, w, w_prev
    out = torch.empty((7, P, N), dtype=torch.float32, device=dev)
    alive_o = torch.empty_like(alive)
    ws = build.workspace(plan.workspace, dev)
    err = _lib().merge2d_launch(
        P, N, plan.threads, plan.smem,
        float(threshold) * float(threshold), float(f_inflation),
        int(max_passes),
        *(t.data_ptr() for t in (mean, cov, w, wp, alive, out, alive_o)),
        build.ptr(ws), plan.workspace, build.stream_of(w))
    if err != 0:
        raise RuntimeError(f"merge2d launch failed: CUDA error {err}")
    launches += 1
    large_launches += plan.form == "large"
    return GMState(mean=out[0:2], cov=out[2:5], w=out[5], w_prev=out[6],
                   alive=alive_o)
