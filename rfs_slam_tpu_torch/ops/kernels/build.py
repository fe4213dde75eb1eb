"""Build and load the package's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` with a plain C entry point.  At first
use it is compiled with nvcc for ``sm_90a`` into ``build/kernels/`` at the
repository root and loaded with :mod:`ctypes`.  The library name carries a
hash of the source and flags, so an edited source never loads a stale
library.  Nothing here runs at import time: the CPU path needs no compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")

# IEEE expf/sqrtf/division: no -use_fast_math.  -Xptxas -v reports each
# kernel's registers, shared memory and spills into the build log.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict[str, ctypes.CDLL] = {}
# name -> (seconds, ptxas report) of the builds made by this process
BUILD_LOG: dict[str, tuple[float, str]] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def checked(t, dtype, device, shape):
    """``t`` as a contiguous tensor a kernel can take: raises on the wrong
    dtype, device or shape."""
    if t.dtype != dtype or t.device != device or tuple(t.shape) != shape:
        raise ValueError(f"kernel input {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}: needs {dtype} {shape} on {device}")
    return t.contiguous()


def stream_of(t) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def load(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if needed and return the loaded library."""
    if name in _LIBS:
        return _LIBS[name]
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    out = os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:12]}.so")
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
        os.replace(tmp, out)
        BUILD_LOG[name] = (time.perf_counter() - t0, proc.stderr.strip())
    lib = ctypes.CDLL(out)
    _LIBS[name] = lib
    return lib
