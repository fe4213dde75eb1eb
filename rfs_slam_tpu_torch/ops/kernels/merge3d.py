"""Gaussian-mixture merge fixpoint for 3-D maps (x, y, tree diameter): CUDA
kernel wrapper and its plain PyTorch twin.

Port of the JAX package's Pallas kernel ``ops/pallas/merge3d.py``.  The
kernel (``csrc/merge3d.cu``) runs the whole pass loop per particle in one
CTA; the twin is :func:`rfs_slam_tpu_torch.ops.gm.merge_fixpoint`, which is
D-generic.

:func:`merge3d` launches the kernel for CUDA tensors and runs the twin for
CPU tensors; nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from rfs_slam_tpu_torch.core.state import GMState
from rfs_slam_tpu_torch.ops import gm as gm_ops
from rfs_slam_tpu_torch.ops.kernels import build

MAX_SLOTS = 1024  # one thread per slot
N_PLANES = 11     # 3 mean, 6 packed cov, w, w_prev

# kernel launches made by merge3d (the twin does not count)
launches = 0


def merge3d_plain(gm: GMState, threshold, f_inflation,
                  max_passes: int = 8) -> GMState:
    """The plain twin: the pass-until-fixpoint loop of ops/gm.py."""
    return gm_ops.merge_fixpoint(gm, threshold, f_inflation, max_passes)


def _lib():
    lib = build.load("merge3d")
    if lib.merge3d_launch.argtypes is None:
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        lib.merge3d_launch.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_int, ptrs, ctypes.c_void_p, ptrs, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.merge3d_launch.restype = ctypes.c_int
    return lib


def _planes(gm: GMState):
    return [gm.mean[k] for k in range(3)] + [gm.cov[k] for k in range(6)] \
        + [gm.w, gm.w_prev]


def merge3d(gm: GMState, threshold, f_inflation,
            max_passes: int = 8) -> GMState:
    """Merge fixpoint of a D=3 mixture whose slots are compacted (alive
    first, by descending weight; see ops/gm.py:merge).  The CUDA kernel for
    CUDA tensors, the plain twin for CPU tensors."""
    if gm.dim != 3:
        raise ValueError(f"merge3d: D={gm.dim}, needs 3-D landmarks")
    if not gm.w.is_cuda:
        return merge3d_plain(gm, threshold, f_inflation, max_passes)
    global launches
    P, N = gm.w.shape
    if N > MAX_SLOTS:
        raise ValueError(f"merge3d: N={N} > {MAX_SLOTS} slots")
    dev = gm.w.device
    gm = GMState(
        mean=build.checked(gm.mean, torch.float32, dev, (3, P, N)),
        cov=build.checked(gm.cov, torch.float32, dev, (6, P, N)),
        w=build.checked(gm.w, torch.float32, dev, (P, N)),
        w_prev=build.checked(gm.w_prev, torch.float32, dev, (P, N)),
        alive=build.checked(gm.alive, torch.bool, dev, (P, N)))
    out = GMState(mean=torch.empty_like(gm.mean),
                  cov=torch.empty_like(gm.cov), w=torch.empty_like(gm.w),
                  w_prev=torch.empty_like(gm.w_prev),
                  alive=torch.empty_like(gm.alive))
    vec = ctypes.c_void_p * N_PLANES
    err = _lib().merge3d_launch(
        P, N, float(threshold) * float(threshold), float(f_inflation),
        int(max_passes), vec(*(t.data_ptr() for t in _planes(gm))),
        gm.alive.data_ptr(), vec(*(t.data_ptr() for t in _planes(out))),
        out.alive.data_ptr(), build.stream_of(gm.w))
    if err != 0:
        raise RuntimeError(f"merge3d launch failed: CUDA error {err}")
    launches += 1
    return out
