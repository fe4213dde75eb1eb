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
# per-kernel flags: the merge kernels round every product and sum as their
# twin does, so their gates decide boundary pairs as the twin decides them;
# the Hungarian's potentials round as its twin's
EXTRA_FLAGS = {"merge2d": ["-fmad=false"], "merge3d": ["-fmad=false"],
               "hungarian": ["-fmad=false"]}

# the dynamic shared memory a Hopper block can opt into (227 KB)
MAX_SMEM = 232_448

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


def sm_count(device) -> int:
    """The streaming multiprocessors of the card ``device`` is on."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def workspace_bytes(P: int, per_particle: int) -> int:
    """Bytes of a large form's global workspace: ``P`` parts of
    ``per_particle`` bytes, each rounded up to 16 so that every part's
    float4 fields are aligned."""
    return P * -(-per_particle // 16) * 16


def merge_large_layout(P: int, N: int, field_bytes: int) -> tuple[int, int]:
    """``(shared memory, workspace)`` bytes of a merge kernel's large form at
    ``P`` particles of ``N`` slots whose gate fields take ``field_bytes``
    a slot (``csrc/merge_bitmask.cuh``'s ``large_layout``).  Shared memory
    holds a 16-byte header, the gate fields, the claims (4 bytes a slot),
    the alive bits, the safe bits and the list of safe words (12 bytes per
    32 slots) while they fit; past that the gate fields, and then the
    rest too, go to a workspace of :func:`workspace_bytes`."""
    header = 16
    fields, claims = field_bytes * N, 4 * N + 12 * -(-N // 32)
    if header + fields + claims <= MAX_SMEM:
        return header + fields + claims, 0
    if header + claims <= MAX_SMEM:
        return header + claims, workspace_bytes(P, fields)
    return header, workspace_bytes(P, fields + claims)


def workspace(nbytes: int, device):
    """A kernel's global workspace of ``nbytes`` (None for 0), from
    PyTorch's caching allocator on the current stream: the launch that
    uses it is queued on that stream, so the memory is reused only after
    the launch."""
    if not nbytes:
        return None
    return torch.empty(-(-nbytes // 4), dtype=torch.float32, device=device)


def ptr(t):
    """A tensor's device address, or None (a null pointer) for None."""
    return None if t is None else t.data_ptr()


def _target(name: str):
    """(source, library path, nvcc flags) of kernel ``name``.  The library
    name hashes the source, the shared headers and the flags."""
    src = os.path.join(CSRC, f"{name}.cu")
    flags = NVCC_FLAGS + EXTRA_FLAGS.get(name, [])
    digest = hashlib.sha1(" ".join(flags).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC, h) for h in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    out = os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:12]}.so")
    return src, out, flags


def load(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if needed and return the loaded library."""
    lib = _LIBS.get(name)
    return lib if lib is not None else load_all([name])[0]


def load_all(names) -> list[ctypes.CDLL]:
    """Compile the kernels ``names`` that are not built yet, one nvcc each,
    all started together, then load them all."""
    pending = []
    for name in names:
        if name in _LIBS:
            continue
        src, out, flags = _target(name)
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            proc = subprocess.Popen([_nvcc(), *flags, "-o", tmp, src],
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
            pending.append((name, src, out, tmp, proc, time.perf_counter()))
    # every nvcc is waited for before a failure is raised
    done = [(*p, p[4].communicate()[1], time.perf_counter()) for p in pending]
    for name, src, out, tmp, proc, t0, err, t1 in done:
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{err}")
        os.replace(tmp, out)
        BUILD_LOG[name] = (t1 - t0, err.strip())
    for name in names:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(_target(name)[1])
    return [_LIBS[name] for name in names]
