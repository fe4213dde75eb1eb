"""Gaussian-mixture merge fixpoint for 2-D maps: CUDA kernel wrapper and
its plain PyTorch twin.

Port of the JAX package's Pallas kernel ``ops/pallas/merge2d.py``.  The
kernel (``csrc/merge2d.cu``) runs the whole pass loop per particle in one
CTA; the twin is :func:`rfs_slam_tpu_torch.ops.gm.merge_fixpoint`.

:func:`merge2d` launches the kernel for CUDA tensors and runs the twin for
CPU tensors; nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from rfs_slam_tpu_torch.core.state import GMState
from rfs_slam_tpu_torch.ops import gm as gm_ops
from rfs_slam_tpu_torch.ops.kernels import build

MAX_SLOTS = 1024  # one thread per slot

# kernel launches made by merge2d (the twin does not count)
launches = 0


def merge2d_plain(gm: GMState, threshold, f_inflation,
                  max_passes: int = 8) -> GMState:
    """The plain twin: the pass-until-fixpoint loop of ops/gm.py."""
    return gm_ops.merge_fixpoint(gm, threshold, f_inflation, max_passes)


def _lib():
    lib = build.load("merge2d")
    if lib.merge2d_launch.argtypes is None:
        lib.merge2d_launch.argtypes = (
            [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
             ctypes.c_int] + [ctypes.c_void_p] * 17)
        lib.merge2d_launch.restype = ctypes.c_int
    return lib


def merge2d(gm: GMState, threshold, f_inflation,
            max_passes: int = 8) -> GMState:
    """Merge fixpoint of a D=2 mixture whose slots are compacted (alive
    first, by descending weight; see ops/gm.py:merge).  The CUDA kernel for
    CUDA tensors, the plain twin for CPU tensors."""
    if gm.dim != 2:
        raise ValueError(f"merge2d: D={gm.dim}, needs 2-D landmarks")
    if not gm.w.is_cuda:
        return merge2d_plain(gm, threshold, f_inflation, max_passes)
    global launches
    P, N = gm.w.shape
    if N > MAX_SLOTS:
        raise ValueError(f"merge2d: N={N} > {MAX_SLOTS} slots")
    dev = gm.w.device
    mean = build.checked(gm.mean, torch.float32, dev, (2, P, N))
    cov = build.checked(gm.cov, torch.float32, dev, (3, P, N))
    w = build.checked(gm.w, torch.float32, dev, (P, N))
    wp = build.checked(gm.w_prev, torch.float32, dev, (P, N))
    alive = build.checked(gm.alive, torch.bool, dev, (P, N))
    out = GMState(mean=torch.empty_like(mean), cov=torch.empty_like(cov),
                  w=torch.empty_like(w), w_prev=torch.empty_like(wp),
                  alive=torch.empty_like(alive))
    err = _lib().merge2d_launch(
        P, N, float(threshold) * float(threshold), float(f_inflation),
        int(max_passes),
        *(t.data_ptr() for t in (mean[0], mean[1], cov[0], cov[1], cov[2],
                                 w, wp, alive, out.mean[0], out.mean[1],
                                 out.cov[0], out.cov[1], out.cov[2], out.w,
                                 out.w_prev, out.alive)),
        build.stream_of(w))
    if err != 0:
        raise RuntimeError(f"merge2d launch failed: CUDA error {err}")
    launches += 1
    return out
