"""The batched Hungarian kernel against an earlier version of it, on one
card in one process.

The earlier version's ``csrc/hungarian.cu`` and ``ops/kernels/
hungarian.py`` are read from ``--old`` (written there with ``git show``),
built with the package's nvcc flags under another library name, and run
through their own wrapper.  Both kernels are held to the plain twin bit for
bit (``row_to_col``, and ``total``, ``u`` and ``v`` as int32 bits) on
``chip_smoke.hungarian_cases`` and on the path's inputs, then timed with
``chip_smoke.cuda_ms`` in turns (old, new, new, old) on:

* the FastSLAM 1.0 DA tables of step 1,500 (``chip_smoke``'s FastSLAM
  phase, generator seed 0, stopped there);
* the four inputs of one MH-FastSLAM update after 2,000 steps (the gated
  root, Murty's root and two waves, ``chip_smoke.recorded_update``);
* random batches at n = 32, 52 and 128.

Each line gives both times, the slowest matrix's search trips (from the
twin) and the time per trip.  Then a copy of the current source with
``clock64()`` stamps (the edits of :data:`CLOCK_EDITS`) splits the slowest
block's cycles on the DA tables into the row searches, the augment walks
and the rest.  Prints the card's name and power limit and each build's
ptxas report.

Usage, from the repository root on a machine with the card::

    mkdir -p build/ab/old
    git show <commit>:rfs_slam_tpu_torch/csrc/hungarian.cu \\
        > build/ab/old/hungarian.cu
    git show <commit>:rfs_slam_tpu_torch/ops/kernels/hungarian.py \\
        > build/ab/old/hungarian.py
    python3 scripts/hungarian_ab.py [--old build/ab/old]
"""

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from rfs_slam_tpu_torch.apps import sim2d_common as loop  # noqa: E402
from rfs_slam_tpu_torch.ops import assignment as A  # noqa: E402
from rfs_slam_tpu_torch.ops.kernels import build  # noqa: E402
from rfs_slam_tpu_torch.ops.kernels import hungarian as hk  # noqa: E402

# the cycle split: (line, replacement) edits of csrc/hungarian.cu, each line
# found exactly once
CLOCK_EDITS = (
    ("namespace {\n",
     "__device__ unsigned long long g_clk[4 * 8192];\nnamespace {\n"),
    ("  const float* M = SMEM ? sA : A;\n",
     "  const float* M = SMEM ? sA : A;\n"
     "  const long long c_begin = clock64();\n"
     "  long long c_search = 0, c_aug = 0, n_trips = 0;\n"),
    ("    int j0 = 0, i0 = p0;\n",
     "    int j0 = 0, i0 = p0;\n    const long long c0 = clock64();\n"),
    ("      i0 = wp;\n    }\n",
     "      i0 = wp;\n      ++n_trips;\n    }\n"
     "    const long long c1 = clock64();\n"),
    ("      j0 = j1;\n    }\n  }\n",
     "      j0 = j1;\n    }\n    c_search += c1 - c0;\n"
     "    c_aug += clock64() - c1;\n  }\n"),
    ("  if (lane == 0) total[b] = t;\n",
     "  if (lane == 0) total[b] = t;\n  if (lane == 0 && b < 8192) {\n"
     "    g_clk[4 * b] = clock64() - c_begin;\n"
     "    g_clk[4 * b + 1] = c_search;\n"
     "    g_clk[4 * b + 2] = c_aug;\n"
     "    g_clk[4 * b + 3] = n_trips;\n  }\n"),
)


def nvcc(src, out):
    flags = build.NVCC_FLAGS + build.EXTRA_FLAGS["hungarian"]
    r = subprocess.run([build._nvcc(), *flags, "-o", out, src],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{r.stderr}")
    return ctypes.CDLL(out), r.stderr.strip()


def old_module(old_dir, out_dir):
    """The earlier wrapper, loading the earlier kernel's library."""
    lib, log = nvcc(os.path.join(old_dir, "hungarian.cu"),
                    os.path.join(out_dir, "hungarian_old.so"))
    print(f"old ptxas:\n{log}", flush=True)
    spec = importlib.util.spec_from_file_location(
        "hungarian_old", os.path.join(old_dir, "hungarian.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.build = types.SimpleNamespace(load=lambda name: lib,
                                      checked=build.checked,
                                      stream_of=build.stream_of)
    return mod


def clock_source():
    """The current source with the stamps of :data:`CLOCK_EDITS`."""
    with open(os.path.join(build.CSRC, "hungarian.cu")) as f:
        src = f.read()
    for line, new in CLOCK_EDITS:
        if src.count(line) != 1:
            raise RuntimeError(f"clock copy: the source changed at "
                               f"{line!r}")
        src = src.replace(line, new)
    return src + ('\nextern "C" int read_clk(void* dst, int nbytes) {\n'
                  '  return static_cast<int>(\n'
                  '      cudaMemcpyFromSymbol(dst, g_clk, nbytes));\n}\n')


def same_bits(a, b):
    def as_int(x):
        return x.view(torch.int32) if x.is_floating_point() else x.long()
    return all(torch.equal(as_int(x), as_int(y)) for x, y in zip(a, b))


def path_inputs(dev):
    """The FastSLAM 1.0 DA tables of step 1,500 and the four MH inputs."""
    filt, sim_cfg, _, inputs = cs.fastslam_setup("fastslam",
                                                 cs.FS_MID_STEP + 2, dev)
    din = loop.device_inputs(inputs, dev)
    mid = {}
    loop.steps(filt, din, torch.Generator(device=dev).manual_seed(0),
               sim_cfg.dt,
               lambda k, state: cs.keep_mid_tables(filt, din, k, state, mid))
    mfilt, msim, _, minputs = cs.fastslam_setup("mhfastslam", cs.MH_STEPS,
                                                dev)
    mdin = loop.device_inputs(minputs, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    mstate = loop.steps(mfilt, mdin, gen, msim.dt, lambda k, s: None)
    return mid["tables"], cs.recorded_update(torch, hk, mfilt, mstate, mdin,
                                             gen)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", default=os.path.join(ROOT, "build", "ab",
                                                  "old"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("hungarian_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    build.load_all(["hungarian"])
    log = build.BUILD_LOG.get("hungarian", (0.0, "(built before)"))[1]
    print(f"new ptxas:\n{log}", flush=True)
    out_dir = os.path.join(ROOT, "build", "ab")
    os.makedirs(out_dir, exist_ok=True)
    old = old_module(args.old, out_dir)
    floor_ms = cs.cuda_ms(torch, torch.zeros(1, device=dev).zero_)
    print(f"launch floor: device ms {floor_ms:.6f}", flush=True)

    def check(name, cost):
        new = hk.hungarian_uv(cost)
        if not same_bits(new, A.hungarian_uv_plain(cost)):
            raise AssertionError(f"new kernel != twin on {name}")
        if not same_bits(old.hungarian_uv(cost), new):
            raise AssertionError(f"old kernel != new kernel on {name}")

    tables, mh = path_inputs(dev)
    cases = cs.hungarian_cases(torch, A, tables, mh, dev)
    for name, cost in cases:
        check(name, cost)
    print(f"old == new == twin on {len(cases)} inputs", flush=True)

    rng = np.random.default_rng(7)

    def rand(B, n):
        return torch.as_tensor((rng.normal(size=(B, n, n)) * 3).astype(
            np.float32), device=dev)

    names = ("MH gated root", "MH Murty root", "MH wave 1", "MH wave 2")
    timed = ([(f"FastSLAM DA tables, step {cs.FS_MID_STEP}", tables)]
             + list(zip(names, mh))
             + [(f"random n={n}", rand(B, n))
                for B, n in ((200, 32), (200, 52), (16, 128))])
    mh_sum = {"old": 0.0, "new": 0.0}
    for name, cost in timed:
        check(name, cost)
        t = {}
        for tag, mod in (("old", old), ("new", hk), ("new2", hk),
                         ("old2", old)):
            t[tag] = cs.cuda_ms(torch, lambda: mod.hungarian_uv(cost))
        trips = A.hungarian_uv_plain(cost, return_trips=True)[4]
        tmax = int(trips.max())
        if name.startswith("MH"):
            mh_sum["old"] += t["old"]
            mh_sum["new"] += t["new"]
        print(json.dumps({
            "ab": name, "B": cost.shape[0], "n": cost.shape[1], **t,
            "k": hk.launch_plan(*cost.shape[:2]).k,
            "trips_per_matrix_max": tmax, "search_trips": int(trips.sum()),
            "ns_per_trip_old": t["old"] * 1e6 / tmax,
            "ns_per_trip_new": t["new"] * 1e6 / tmax,
            "floor_ms": floor_ms, "card": card}), flush=True)
    print(json.dumps({"mh_four_launches_ms": mh_sum, "card": card}),
          flush=True)

    src = os.path.join(out_dir, "hungarian_clock.cu")
    with open(src, "w") as f:
        f.write(clock_source())
    lib, _ = nvcc(src, os.path.join(out_dir, "hungarian_clock.so"))
    lib.read_clk.argtypes = [ctypes.c_void_p, ctypes.c_int]
    keep = build._LIBS["hungarian"]
    build._LIBS["hungarian"] = lib
    try:
        got = hk.hungarian_uv(tables)
    finally:
        build._LIBS["hungarian"] = keep
    if not same_bits(got, A.hungarian_uv_plain(tables)):
        raise AssertionError("the clock copy != twin")
    torch.cuda.synchronize()
    B = tables.shape[0]
    buf = (ctypes.c_ulonglong * (4 * B))()
    err = lib.read_clk(ctypes.addressof(buf), 8 * 4 * B)
    if err != 0:
        raise RuntimeError(f"read_clk: CUDA error {err}")
    c = np.frombuffer(buf, dtype=np.uint64).reshape(B, 4).astype(
        np.float64)
    s = int(np.argmax(c[:, 0]))
    sm = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(json.dumps({
        "clock_on": f"FastSLAM DA tables, step {cs.FS_MID_STEP}",
        "slowest_block": s, "cycles": c[s, 0], "search_cycles": c[s, 1],
        "augment_cycles": c[s, 2], "trips": c[s, 3],
        "search_cycles_per_trip": c[s, 1] / c[s, 3],
        "sm_clocks_after": sm, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
