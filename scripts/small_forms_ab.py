"""The small forms (M, N <= 1,024 slots) of ``map_update2d``, ``merge2d``
and ``merge3d`` against an earlier version of their sources, on one card
in one process.

The earlier ``csrc/`` is read from ``--old``.  Both it and the package's
``rfs_slam_tpu_torch/csrc/`` are built with the package's nvcc flags into
``build/ab/lib/``, and each is called through its own C entry: the entries
before the large forms take no workspace, after their redesign the map
update's also takes a stats pointer, and the script tells them apart by
their source.  On every case the two builds' outputs must be equal to
the bit; then each is timed in turns (old, new, new, old) with
``chip_smoke.cuda_ms``, the stream held busy first.  The cases are random
inputs at the main paths' shapes:

* ``merge2d``: P=200, N=128 (the 2-D replay's map), and P=200, N=512;
* ``merge3d``: P=100, N=512 (Victoria Park RB-PHD's map);
* ``map_update2d``: P=200, M=128, Zc=40, T=8 (the replay's update).

Prints one JSON line a case (both builds' four times and their medians),
each build's ptxas report, and the card's name and power limit.

Usage, from the repository root on a machine with the card::

    mkdir -p build/ab/old
    git archive <commit> rfs_slam_tpu_torch/csrc | tar -x -C build/ab/old
    python3 scripts/small_forms_ab.py \\
        --old build/ab/old/rfs_slam_tpu_torch/csrc
"""

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from rfs_slam_tpu_torch.apps import example_step as ex  # noqa: E402
from rfs_slam_tpu_torch.core.state import GMState  # noqa: E402
from rfs_slam_tpu_torch.ops.kernels import build  # noqa: E402
from rfs_slam_tpu_torch.ops.kernels import map_update2d as mu  # noqa: E402
from rfs_slam_tpu_torch.ops.kernels import merge2d as mg  # noqa: E402
from rfs_slam_tpu_torch.ops.kernels import merge3d as m3  # noqa: E402

KERNELS = ("merge2d", "merge3d", "map_update2d")
LIB_DIR = os.path.join(ROOT, "build", "ab", "lib")
vp = ctypes.c_void_p


def build_all(srcs):
    """``{(version, kernel): (CDLL, workspace ABI, ptxas report)}``: every
    kernel of every source directory, one nvcc each, all started
    together."""
    os.makedirs(LIB_DIR, exist_ok=True)
    procs = []
    for ver, d in srcs.items():
        for k in KERNELS:
            src = os.path.join(d, f"{k}.cu")
            with open(src) as f:
                text = f.read()
            # the merges' workspace; the map update's stash and stats
            # pointers (how many)
            ws_abi = ("ws_bytes" in text if k != "map_update2d"
                      else ("void* stash" in text) + ("int* stats" in text))
            out = os.path.join(LIB_DIR, f"{k}-{ver}.so")
            flags = build.NVCC_FLAGS + build.EXTRA_FLAGS.get(k, [])
            # the source's own directory first: its shared header
            procs.append((ver, k, out, ws_abi, subprocess.Popen(
                [build._nvcc(), *flags, "-I", d, "-o", out, src],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    libs = {}
    for ver, k, out, ws_abi, proc in procs:
        err = proc.communicate()[1]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {ver} {k}:\n{err}")
        libs[ver, k] = (ctypes.CDLL(out), ws_abi, [
            line.strip() for line in err.splitlines() if "registers" in line])
    return libs


def merge_call(lib, k, gm, thr, infl, stream):
    fn, ws_abi, _ = lib
    P, N = gm.w.shape
    plan = (mg if k == "merge2d" else m3).launch_plan(P, N)
    out = torch.empty((7 if k == "merge2d" else 11, P, N),
                      device=gm.w.device)
    alive_o = torch.empty_like(gm.alive)
    ptrs = [vp(t.data_ptr()) for t in (gm.mean, gm.cov, gm.w, gm.w_prev,
                                       gm.alive, out, alive_o)]
    tail = [vp(None), ctypes.c_size_t(0)] if ws_abi else []
    err = getattr(fn, f"{k}_launch")(
        ctypes.c_int(P), ctypes.c_int(N), ctypes.c_int(plan.threads),
        ctypes.c_int(plan.smem), ctypes.c_float(thr * thr),
        ctypes.c_float(infl), ctypes.c_int(8), *ptrs, *tail, vp(stream))
    if err != 0:
        raise RuntimeError(f"{k} launch failed: CUDA error {err}")
    return out, alive_o


def map_update_call(lib, a, stream):
    fn, ws_abi, _ = lib
    pose, mx, my, c00, c01, c11, w, wp, alive, z, zm, params, T = a
    P, M = w.shape
    Zc = z.shape[0]
    plan = mu.launch_plan(P, M, Zc, T)
    out = torch.empty(12 * P * M + P * Zc * (1 + T), device=w.device)
    unused = torch.empty((P, Zc), dtype=torch.bool, device=w.device)
    cand_m = torch.empty((P, T * Zc), dtype=torch.int64, device=w.device)
    ptrs = [vp(t.data_ptr()) for t in (pose, mx, my, c00, c01, c11, w, wp,
                                       alive, z, zm, out, unused, cand_m)]
    err = fn.map_update2d_launch(
        *(ctypes.c_int(v) for v in (P, M, Zc, T, plan.threads, plan.smem,
                                    plan.zb)),
        mu._c_params(tuple(params)), *ptrs, *[vp(None)] * ws_abi,
        vp(stream))
    if err != 0:
        raise RuntimeError(f"map_update2d launch failed: CUDA error {err}")
    return out, unused, cand_m


def bit_equal(xs, ys):
    as_int = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
    return all(torch.equal(as_int(x), as_int(y)) for x, y in zip(xs, ys))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True,
                    help="the earlier version's csrc directory")
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    libs = build_all({"old": os.path.abspath(args.old),
                      "new": os.path.join(ROOT, "rfs_slam_tpu_torch",
                                          "csrc")})
    rng = np.random.default_rng(0)
    params = ex.build(4, 128, 8, dev)._map_params
    cases = [
        ("merge2d", "P=200 N=128", cs.random_mixtures(
            torch, GMState, rng, 200, 128, dev)),
        ("merge2d", "P=200 N=512", cs.random_mixtures(
            torch, GMState, rng, 200, 512, dev, (100, 400))),
        ("merge3d", "P=100 N=512", cs.random_mixtures3(
            torch, GMState, rng, 100, 512, dev)),
        ("map_update2d", "P=200 M=128 Zc=40 T=8", cs.large_map_inputs(
            torch, rng, params, 200, 128, 40, dev)),
    ]
    for k, shape, x in cases:
        if k == "map_update2d":
            call = {v: (lambda v=v: map_update_call(libs[v, k], x, stream))
                    for v in ("old", "new")}
        else:
            call = {v: (lambda v=v: merge_call(libs[v, k], k, x, 1.5, 1.5,
                                               stream))
                    for v in ("old", "new")}
        old, new = call["old"](), call["new"]()
        torch.cuda.synchronize()
        if not bit_equal(old, new):
            raise AssertionError(f"{k} {shape}: the builds' outputs differ")
        times = {"old": [], "new": []}
        for v in ("old", "new", "new", "old"):
            times[v].append(cs.cuda_ms(torch, call[v]))
        print(json.dumps({"kernel": k, "shape": shape, "bit_equal": True,
                          "ms": times,
                          "median_ms": {v: statistics.median(t)
                                        for v, t in times.items()}}),
              flush=True)
    for (ver, k), (_, _, regs) in sorted(libs.items()):
        print(f"{ver} {k}: {regs}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
