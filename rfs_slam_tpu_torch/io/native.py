"""ctypes bindings over the native I/O runtime ``native/rfsio.cpp`` (port
of the JAX package's ``io/native.py``): the reference-format
particlePose.dat / landmarkEst.dat writers and a bulk numeric-text parser,
the fprintf/fscanf tier of the reference apps (rbphdslam2dSim.cpp:369-441,
rbphdslam_VictoriaPark.cpp:199-324).

At first use the library is compiled with ``g++ -O3 -shared -fPIC`` into
``build/native/`` at the repository root, under a name that hashes the
source and the flags (an edited source never loads a stale library).
Without a C++ compiler :func:`lib` returns None and the callers take their
numpy paths, which write the same bytes; a compiler that fails raises.

C's ``%f`` prints a NaN with its sign bit set as ``-nan`` where Python
prints ``nan``: the writers pass every NaN to the library as a NaN without
the sign bit, so both paths print ``nan``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "native", "rfsio.cpp")
BUILD_DIR = os.path.join(_ROOT, "build", "native")
FLAGS = ["-O3", "-shared", "-fPIC"]

_LIB = None
_TRIED = False


def _compiler() -> str | None:
    return shutil.which("g++") or shutil.which("c++")


def library_path() -> str:
    """Where the library for the current source and flags is built."""
    digest = hashlib.sha1(" ".join(FLAGS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"librfsio-{digest.hexdigest()[:12]}.so")


def build() -> str | None:
    """Compile the library if needed; its path, or None without a compiler."""
    out = library_path()
    if os.path.exists(out):
        return out
    cxx = _compiler()
    if cxx is None:
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed for {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def lib():
    """The loaded library, built at first use; None without a compiler."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = build()
    if path is None:
        return None
    L = ctypes.CDLL(path)
    dp, lp = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_long)
    L.rfsio_write_particle_poses.restype = ctypes.c_int
    L.rfsio_write_particle_poses.argtypes = [
        ctypes.c_char_p, dp, dp, dp, ctypes.c_long, ctypes.c_long]
    L.rfsio_write_landmark_estimates.restype = ctypes.c_int
    L.rfsio_write_landmark_estimates.argtypes = [
        ctypes.c_char_p, dp, lp, dp, dp, dp,
        ctypes.POINTER(ctypes.c_ubyte), ctypes.c_long, ctypes.c_long]
    L.rfsio_read_values.restype = ctypes.c_long
    L.rfsio_read_values.argtypes = [ctypes.c_char_p, dp, ctypes.c_long]
    _LIB = L
    return _LIB


def _doubles(a):
    """A contiguous float64 copy whose NaNs have no sign bit."""
    a = np.array(a, np.float64, order="C")
    a[np.isnan(a)] = np.nan
    return a


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def write_particle_poses(path: str, times, poses, weights) -> bool:
    """Native particlePose.dat writer; False without the library."""
    L = lib()
    if L is None:
        return False
    times, poses, weights = map(_doubles, (times, poses, weights))
    T, P, _ = poses.shape
    rc = L.rfsio_write_particle_poses(
        path.encode(), _dptr(times), _dptr(poses), _dptr(weights), T, P)
    if rc != 0:
        raise OSError(f"rfsio could not write {path}")
    return True


def write_landmark_estimates(path: str, times, best, means, covs_packed,
                             ws, alive) -> bool:
    """Native landmarkEst.dat writer (``means [T, M, 2]``, packed
    ``[T, M, 3]`` covariances); False without the library."""
    L = lib()
    if L is None:
        return False
    times, means, covs, ws = map(_doubles, (times, means, covs_packed, ws))
    best = np.ascontiguousarray(best, np.int64)
    alive = np.ascontiguousarray(alive, np.uint8)
    T, M, _ = means.shape
    rc = L.rfsio_write_landmark_estimates(
        path.encode(), _dptr(times),
        best.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        _dptr(means), _dptr(covs), _dptr(ws),
        alive.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), T, M)
    if rc != 0:
        raise OSError(f"rfsio could not write {path}")
    return True


def read_values(path: str) -> np.ndarray | None:
    """Every number of a text file in order; None without the library."""
    L = lib()
    if L is None:
        return None
    n = L.rfsio_read_values(path.encode(), None, 0)
    if n < 0:
        raise OSError(f"rfsio could not read {path}")
    out = np.empty(n, np.float64)
    if L.rfsio_read_values(path.encode(), _dptr(out), n) != n:
        raise OSError(f"rfsio: {path} changed while read")
    return out


def loadtxt(path: str, ncols: int | None = None) -> np.ndarray | None:
    """``np.loadtxt`` of a file of uniform columns through the native
    parser (rows ``[-1, ncols]``, ``ncols`` from the first data line by
    default); None without the library."""
    vals = read_values(path)
    if vals is None:
        return None
    if ncols is None:
        with open(path) as f:
            for line in f:
                if line.strip() and not line.startswith("#"):
                    ncols = len(line.split())
                    break
    return vals.reshape(-1, ncols) if ncols else vals
