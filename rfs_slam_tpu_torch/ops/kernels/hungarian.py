"""Batched Hungarian (shortest augmenting path with dual potentials): CUDA
kernel wrapper.

The JAX package computes its ``_hungarian_uv`` (``ops/assignment.py``) with
no Pallas kernel: a ``fori_loop`` over the rows around a ``while_loop``
search whose trip count differs per lane, under ``vmap``.  In plain PyTorch
that is thousands of small launches, and a host test per trip, for work
that is one warp's: the kernel (``csrc/hungarian.cu``) solves each matrix in
one CTA of one warp, with the matrix in shared memory and the search state
in registers (lane ``l`` owns columns and rows ``1 + l + 32 k``, ``k < K``).
Its twin is :func:`rfs_slam_tpu_torch.ops.assignment.hungarian_uv_plain`.

:func:`hungarian_uv` launches the kernel for CUDA tensors and runs the twin
for CPU tensors; nothing falls back.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from rfs_slam_tpu_torch.ops import assignment
from rfs_slam_tpu_torch.ops.kernels import build

MAX_N = 1024
THREADS = 32   # one warp a matrix
KS = (1, 2, 4, 8, 16, 32)   # the kernel's instantiations: columns a lane owns

# kernel launches made by hungarian_uv (the twin does not count)
launches = 0


class LaunchPlan(NamedTuple):
    threads: int   # one warp
    smem: int      # dynamic shared memory bytes
    k: int         # columns (and rows) a lane owns: ceil(n / 32), rounded up
    in_smem: bool  # the cost matrix copied into shared memory


def launch_plan(B: int, n: int) -> LaunchPlan:
    """The kernel's launch configuration: one CTA of one warp per matrix,
    each lane owning ``k`` columns and rows (the least of :data:`KS` with
    ``32 k >= n``).  Shared memory holds the cost matrix (``n * n`` f32)
    where it fits a block's (``build.MAX_SMEM``, so n <= 240), and the row
    -> column map (``n`` int32); a larger matrix is read from global
    memory.  Raises ``ValueError`` for a shape the kernel does not take."""
    if B < 1 or not 1 <= n <= MAX_N:
        raise ValueError(f"hungarian: no launch for B={B}, n={n} "
                         f"(B >= 1, 1 <= n <= {MAX_N})")
    k = next(k for k in KS if 32 * k >= n)
    matrix = 4 * n * n
    in_smem = matrix + 4 * n <= build.MAX_SMEM
    return LaunchPlan(THREADS, (matrix if in_smem else 0) + 4 * n, k,
                      in_smem)


def _lib():
    lib = build.load("hungarian")
    if lib.hungarian_launch.argtypes is None:
        lib.hungarian_launch.argtypes = [ctypes.c_int] * 6 + [
            ctypes.c_void_p] * 6
        lib.hungarian_launch.restype = ctypes.c_int
    return lib


def hungarian_uv(cost: torch.Tensor):
    """``(row_to_col [B, n], total [B], u [B, n+1], v [B, n+1])`` of each
    max-sum assignment problem of ``cost [B, n, n]`` (float32).  The CUDA
    kernel for CUDA tensors (``row_to_col`` int32), the plain twin for CPU
    tensors (int64)."""
    if not cost.is_cuda:
        return assignment.hungarian_uv_plain(cost)
    global launches
    B, n, _ = cost.shape
    dev = cost.device
    if B == 0:
        return (torch.empty((0, n), dtype=torch.int32, device=dev),
                torch.empty((0,), device=dev),
                torch.empty((0, n + 1), device=dev),
                torch.empty((0, n + 1), device=dev))
    plan = launch_plan(B, n)
    c = build.checked(cost, torch.float32, dev, (B, n, n))
    row_to_col = torch.empty((B, n), dtype=torch.int32, device=dev)
    total = torch.empty((B,), dtype=torch.float32, device=dev)
    uv = torch.empty((2, B, n + 1), dtype=torch.float32, device=dev)
    err = _lib().hungarian_launch(
        B, n, *plan, c.data_ptr(), row_to_col.data_ptr(), total.data_ptr(),
        uv[0].data_ptr(), uv[1].data_ptr(), build.stream_of(c))
    if err != 0:
        raise RuntimeError(f"hungarian launch failed: CUDA error {err}")
    launches += 1
    return row_to_col, total, uv[0], uv[1]
