"""The large forms (M, N > 1,024 slots) of ``map_update2d``, ``merge2d``
and ``merge3d`` against an earlier version of their sources, on one card
in one process.

The earlier kernels and their wrappers' launch plans are read from
``--old``, a directory holding an earlier commit's
``rfs_slam_tpu_torch/csrc/`` and ``rfs_slam_tpu_torch/ops/kernels/``.  Both
versions are built with the package's nvcc flags into ``build/ab/lib/``
and each is called through its own C entry with its own plan (workspace
included).  On every case the two builds' outputs must be equal to the
bit; then each is timed in turns (old, new, new, old) with
``chip_smoke.cuda_ms``, the stream held busy first.  The cases:

* ``map_update2d``: random inputs at P=200, M=1,025, Zc=40; the replay's
  mid-run state (``chip_smoke.midrun``: P=200, M=128, Zc=40) padded with
  dead slots to 2,048; the overflow shape (P=64, M=8,192, Zc=16: the
  example state of ``apps/example_step.py`` predicted one step); and, not
  timed, edge inputs at M=2,048 (negative weights, T=1, ties, zero
  clutter with masked and empty columns, every slot alive);
* ``merge2d``: the mid-run state's merge input (P=200, N=128: the small
  form), random mixtures at P=200, N=1,025; the merge input padded to
  2,048; the overflow step's merge input (P=64, N=8,192); past the slots
  whose fixpoint data fits in shared memory, random mixtures spread to a
  few gated neighbours a slot at P=2, N=12,288 (the gate fields in the
  workspace) and P=1, N=53,248 (all in the workspace), timed over fewer
  calls; and, not timed, every slot alive at N=2,048 and
  ``chip_smoke``'s edge mixtures padded to 2,048;
* ``merge3d``: the merge input of Victoria Park RB-PHD's frame 2,000
  (``chip_smoke``'s stream and filter, P=100, N=512: the small form), the
  same padded to 2,048; random and all-alive mixtures at P=16, N=1,025
  and 2,048; random mixtures at N=8,192 (P=2 and P=100: the gate fields
  in the workspace) and, spread to a few gated neighbours a slot, at P=1,
  N=53,248 (all in the workspace); and, not timed, ``chip_smoke``'s D=3
  edge mixtures padded to 2,048.

Two studies of the new ``merge3d`` follow.  The sweep A/B builds it again
with the one-row ``safe_sweep`` in place of ``safe_sweep2`` (a text edit
of the source) and times both, bit-equal, in turns on the padded Victoria
Park input and at N=8,192.  The clock split builds the old and the new
``merge3d`` with ``clock64()`` stamps at each barrier of the large form
(text edits, ``CLOCK_EDITS``, for the earlier gate-mask form and for the
mask-free form; it raises if a kernel changed under one),
runs each on the padded Victoria Park input and prints each phase's
cycles, the mean over the CTAs.

For the new ``map_update2d`` each case prints the kernel's own counts: the
largest number of a particle's table slots, the particles whose stash went
to the workspace and the most table chunks of one; for the merges the
passes of the fixpoint (the twin's, a few particles at a time on the
alive prefix, up to 16,384 slots) and both plans.  One JSON line a case,
then each build's ptxas report and the card's name and power limit.

Usage, from the repository root on a machine with the card::

    mkdir -p build/ab/old
    git archive <commit> rfs_slam_tpu_torch/csrc \\
        rfs_slam_tpu_torch/ops/kernels | tar -x -C build/ab/old
    python3 scripts/large_forms_ab.py --old build/ab/old
"""

import argparse
import ctypes
import importlib.util
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
from rfs_slam_tpu_torch.apps import rbphdslam2dsim as app  # noqa: E402
from rfs_slam_tpu_torch.apps import rbphdslam_victoriapark as vp_app  # noqa: E402,E501
from rfs_slam_tpu_torch.apps import sim2d_common as loop  # noqa: E402
from rfs_slam_tpu_torch.core.state import GMState  # noqa: E402
from rfs_slam_tpu_torch.io import sim2d  # noqa: E402
from rfs_slam_tpu_torch.io import victoria_park as vp_io  # noqa: E402
from rfs_slam_tpu_torch.io.xmlconfig import XmlConfig  # noqa: E402
from rfs_slam_tpu_torch.ops import gm as gm_ops  # noqa: E402
from rfs_slam_tpu_torch.ops.kernels import build  # noqa: E402
from rfs_slam_tpu_torch.ops.kernels import map_update2d as mu  # noqa: E402
from rfs_slam_tpu_torch.ops.kernels import merge2d as mg  # noqa: E402
from rfs_slam_tpu_torch.ops.kernels import merge3d as m3  # noqa: E402

KERNELS = ("merge2d", "merge3d", "map_update2d")
LIB_DIR = os.path.join(ROOT, "build", "ab", "lib")
SRC_DIR = os.path.join(ROOT, "build", "ab", "src")   # edited sources
PAD = 2048
OVERFLOW = (64, 8192, 16)
# P, N, what goes to the workspace: merge2d past the slots whose fixpoint
# data fits in shared memory
WORKSPACE_CASES = ((2, 12288, "gate fields"), (1, 53248, "all"))
TRACE_SLOTS = 16384   # the most slots whose twin trace gives the passes
OUT_PLANES = {"merge2d": 7, "merge3d": 11}
# the one-row sweep in the new merge3d's place (the sweep A/B)
ONE_ROW_EDIT = ("merge_bitmask::safe_sweep2(gate",
                "merge_bitmask::safe_sweep(gate")
# clock64() stamps: cycles a CTA's thread 0 spends from one barrier of the
# large form to the next, summed into clk[CTA][phase] (phase 5: passes)
CLOCK_PHASES = ("copy in", "gate rows / safe sweep",
                "claims (with the safe list)", "merge and any", "copy out")
CLOCK_PRELUDE = """
__device__ unsigned long long clk[4096 * 8];
extern "C" int merge3d_clock(void* dst, int P) {
  cudaError_t e = cudaMemcpyFromSymbol(dst, clk, P * 8 * sizeof(long long));
  if (e != cudaSuccess) return static_cast<int>(e);
  static unsigned long long zero[4096 * 8];
  return static_cast<int>(cudaMemcpyToSymbol(clk, zero, sizeof(zero)));
}
#define CLK_START long long clk_t = clock64();
#define CLK(ph)                                                  \\
  if (threadIdx.x == 0) {                                        \\
    const long long clk_n = clock64();                           \\
    clk[blockIdx.x * 8 + (ph)] += clk_n - clk_t;                 \\
    clk_t = clk_n;                                               \\
    if ((ph) == 3) clk[blockIdx.x * 8 + 5] += 1;                 \\
  }
"""
# where the large form starts, [(text, replacement)]: each text must occur
# exactly once after the start.  The earlier gate-mask form (one kernel
# template for both forms) and the mask-free large form.
CLOCK_EDITS = {
    "mask": ("merge3d_kernel(", [
        ("  using merge_bitmask::for_slots;\n",
         "  using merge_bitmask::for_slots;\n  CLK_START\n"),
        ("  const int hi = s_hi;\n", "  const int hi = s_hi;\n  CLK(0)\n"),
        ("s_gate, s_safe);\n    __syncthreads();\n",
         "s_gate, s_safe);\n    __syncthreads();\n    CLK(1)\n"),
        ("s_safe, s_jstar);\n    });\n    __syncthreads();\n",
         "s_safe, s_jstar);\n    });\n    __syncthreads();\n    CLK(2)\n"),
        ("    if (!__syncthreads_or(any)) break;\n",
         "    const int clk_any = __syncthreads_or(any);\n    CLK(3)\n"
         "    if (!clk_any) break;\n"),
        ("    alive_out[pi] = s_alive[i] != 0;\n  });\n}",
         "    alive_out[pi] = s_alive[i] != 0;\n  });\n  __syncthreads();\n"
         "  CLK(4)\n}")]),
    "mask-free": ("merge3d_large(", [
        ("  if (threadIdx.x == 0) *s_hi = 0;\n",
         "  CLK_START\n  if (threadIdx.x == 0) *s_hi = 0;\n"),
        ("  const int hi = *s_hi;\n", "  const int hi = *s_hi;\n  CLK(0)\n"),
        ("hi, safe);\n    __syncthreads();\n",
         "hi, safe);\n    __syncthreads();\n    CLK(1)\n"),
        ("                               link);\n    __syncthreads();\n",
         "                               link);\n    __syncthreads();\n"
         "    CLK(2)\n"),
        ("    if (!__syncthreads_or(any)) break;\n",
         "    const int clk_any = __syncthreads_or(any);\n    CLK(3)\n"
         "    if (!clk_any) break;\n"),
        ("    alive_out[pi] = bit(alive, i);\n  }\n}",
         "    alive_out[pi] = bit(alive, i);\n  }\n  __syncthreads();\n"
         "  CLK(4)\n}")])}
vp = ctypes.c_void_p


def plan_module(old_dir, k):
    """The earlier wrapper module of kernel ``k`` (its launch_plan)."""
    path = os.path.join(old_dir, "rfs_slam_tpu_torch", "ops", "kernels",
                        f"{k}.py")
    spec = importlib.util.spec_from_file_location(f"old_{k}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def edited(src, ver, edits, start=None, prelude=""):
    """``src`` with each ``(text, replacement)`` of ``edits`` made once
    after ``start`` (each text must occur there exactly once) and
    ``prelude`` after its includes, written to ``build/ab/src/<ver>/``."""
    with open(src) as f:
        text = f.read()
    cut = text.index(start) if start else 0
    head, tail = text[:cut], text[cut:]
    for old, new in edits:
        if tail.count(old) != 1:
            raise RuntimeError(f"{src}: {old!r} occurs {tail.count(old)} "
                               f"times: the kernel changed under the edit")
        tail = tail.replace(old, new)
    inc = '#include "merge_bitmask.cuh"\n'
    head = head.replace(inc, inc + prelude)
    out = os.path.join(SRC_DIR, ver, os.path.basename(src))
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        f.write(head + tail)
    return out


def build_all(jobs):
    """``{(version, kernel): (CDLL, ptxas report)}`` of ``jobs``,
    ``(version, kernel, source, header directory)``: one nvcc each, all
    started together."""
    os.makedirs(LIB_DIR, exist_ok=True)
    procs = []
    for ver, k, src, inc in jobs:
        out = os.path.join(LIB_DIR, f"{k}-large-{ver}.so")
        flags = build.NVCC_FLAGS + build.EXTRA_FLAGS.get(k, [])
        procs.append((ver, k, out, subprocess.Popen(
            [build._nvcc(), *flags, "-I", inc, "-o", out, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    libs = {}
    for ver, k, out, proc in procs:
        err = proc.communicate()[1]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {ver} {k}:\n{err}")
        libs[ver, k] = (ctypes.CDLL(out), [
            line.strip() for line in err.splitlines() if "registers" in line])
    return libs


class Version:
    """One build of the kernels with its own plans and C entries."""

    def __init__(self, libs, ver, plans, new_abi=True):
        self.libs = {k: lib for (v, k), (lib, _) in libs.items() if v == ver}
        self.plans = plans
        self.new_abi = new_abi   # map_update2d's stats

    def merge(self, k, gm, thr, infl, stream):
        P, N = gm.w.shape
        plan = self.plans[k].launch_plan(P, N)
        out = torch.empty((OUT_PLANES[k], P, N), device=gm.w.device)
        alive_o = torch.empty_like(gm.alive)
        ws = build.workspace(plan.workspace, gm.w.device)
        ptrs = [vp(t.data_ptr()) for t in (gm.mean, gm.cov, gm.w, gm.w_prev,
                                           gm.alive, out, alive_o)]
        err = getattr(self.libs[k], f"{k}_launch")(
            ctypes.c_int(P), ctypes.c_int(N), ctypes.c_int(plan.threads),
            ctypes.c_int(plan.smem), ctypes.c_float(thr * thr),
            ctypes.c_float(infl), ctypes.c_int(8), *ptrs,
            vp(build.ptr(ws)), ctypes.c_size_t(plan.workspace), vp(stream))
        if err != 0:
            raise RuntimeError(f"{k} launch failed: CUDA error {err}")
        return out, alive_o

    def map_update(self, a, stream, stats=None):
        pose, mx, my, c00, c01, c11, w, wp, alive, z, zm, params, T = a
        P, M = w.shape
        Zc = z.shape[0]
        plan = self.plans["map_update2d"].launch_plan(
            P, M, Zc, T, *([build.sm_count(w.device)] if self.new_abi
                           else []))
        out = torch.empty(12 * P * M + P * Zc * (1 + T), device=w.device)
        unused = torch.empty((P, Zc), dtype=torch.bool, device=w.device)
        cand_m = torch.empty((P, T * Zc), dtype=torch.int64, device=w.device)
        stash = build.workspace(plan.workspace, w.device)
        ptrs = [vp(t.data_ptr()) for t in (pose, mx, my, c00, c01, c11, w, wp,
                                           alive, z, zm, out, unused, cand_m)]
        tail = [vp(build.ptr(stash))]
        if self.new_abi:
            tail.append(vp(build.ptr(stats)))
        err = self.libs["map_update2d"].map_update2d_launch(
            *(ctypes.c_int(v) for v in (P, M, Zc, T, plan.threads, plan.smem,
                                        plan.zb)),
            mu._c_params(tuple(params)), *ptrs, *tail, vp(stream))
        if err != 0:
            raise RuntimeError(f"map_update2d launch failed: CUDA error "
                               f"{err}")
        return out, unused, cand_m


def bit_equal(xs, ys):
    as_int = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
    return all(torch.equal(as_int(x), as_int(y)) for x, y in zip(xs, ys))


def padded(x, n):
    return cs.pad_slots(torch, x, n)


def padded_gm(g, n):
    return GMState(*[padded(x, n) for x in (g.mean, g.cov, g.w, g.w_prev,
                                            g.alive)])


def map_update_cases(dev, rng):
    """(name, args, timed) of the map update's cases."""
    sim_cfg = sim2d.Sim2DConfig()
    filt = app.build_filter(sim_cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    state, z, z_mask = cs.midrun(torch, app, loop, filt, gen, sim_cfg.dt)
    gm = state.gm
    mid = (state.particles.pose, gm.mean[0], gm.mean[1], gm.cov[0],
           gm.cov[1], gm.cov[2], gm.w, gm.w_prev, gm.alive, z, z_mask,
           filt._map_params, filt.cfg.new_per_z)
    pad = (mid[0], *[padded(x, PAD) for x in mid[1:9]], *mid[9:])
    params = filt._map_params
    cases = [("random P=200 M=1025 Zc=40",
              cs.large_map_inputs(torch, rng, params, 200, 1025, 40, dev),
              True),
             (f"mid-run padded to {PAD}", pad, True)]
    P, M, Zc = OVERFLOW
    ofilt = ex.build(P, M, Zc, dev)
    ostate, odo, oz, ozm = ex.example_inputs(ofilt, dev)
    ostate = ofilt.predict(ostate, odo, ex.DT,
                           gen=torch.Generator(device=dev).manual_seed(0))
    g = ostate.gm
    over = (ostate.particles.pose, g.mean[0], g.mean[1], g.cov[0], g.cov[1],
            g.cov[2], g.w, g.w_prev, g.alive, oz, ozm, ofilt._map_params,
            min(ofilt.cfg.new_per_z, M))
    cases.append((f"overflow P={P} M={M} Zc={Zc}", over, True))
    r = cs.large_map_inputs(torch, rng, params, 16, PAD, 40, dev)
    neg = r[6].clone()
    neg[:, ::3] *= -1.0
    no_clutter = (*params[:4], 0.0, *params[5:])
    empty_z = r[10].clone()
    empty_z[1::2] = False
    all_alive = torch.ones_like(r[8])
    half = [torch.cat([x[:, :PAD // 2]] * 2, dim=1) for x in r[1:9]]
    cases += [("negative weights M=2048", (*r[:6], neg, *r[7:]), False),
              ("T=1 M=2048", (*r[:-1], 1), False),
              ("ties M=2048", (r[0], *half, *r[9:]), False),
              ("no clutter, masked columns M=2048",
               (*r[:10], empty_z, no_clutter, r[12]), False),
              ("no clutter, negative weights M=2048",
               (*r[:6], neg, *r[7:10], empty_z, no_clutter, r[12]), False),
              ("every slot alive M=2048", (*r[:8], all_alive, *r[9:]),
               False)]
    return cases, (filt, state, z, z_mask), (ofilt, ostate, oz, ozm)


def merge2d_cases(dev, rng, mid, over):
    """(kernel, name, mixture, threshold, inflation, calls timed, 0 for
    none) of merge2d's cases."""
    filt, state, z, z_mask = mid
    full = filt._map_update(state, z, z_mask)[0]
    merge_in = gm_ops.compact(full, full.capacity)
    thr, infl = filt.cfg.merge_threshold, filt.cfg.merge_inflation
    ofilt, ostate, oz, ozm = over
    ofull = ofilt._map_update(ostate, oz, ozm)[0]
    omerge = gm_ops.compact(ofull, ofull.capacity)
    cases = [("mid-run merge input P=200 N=128 (small form)", merge_in, thr,
              infl, 25),
             ("random P=200 N=1025", cs.random_mixtures(
                 torch, GMState, rng, 200, 1025, dev, (500, 1025)), 1.5, 1.5,
              25),
             (f"mid-run merge input padded to {PAD}", padded_gm(merge_in,
                                                                PAD), thr,
              infl, 25),
             (f"overflow merge input P={OVERFLOW[0]} N={OVERFLOW[1]}", omerge,
              ofilt.cfg.merge_threshold, ofilt.cfg.merge_inflation, 25)]
    for P, N, tier in WORKSPACE_CASES:
        cases.append((f"random P={P} N={N} ({tier} in the workspace)",
                      cs.random_mixtures(torch, GMState, rng, P, N, dev,
                                         (N - N // 8, N), 0.4 * N ** 0.5),
                      1.5, 1.5, 5))
    cases.append(("every slot alive N=2048", cs.random_mixtures(
        torch, GMState, rng, 16, PAD, dev, (PAD, PAD)), 1.5, 1.5, 0))
    cases += [(f"{name} padded to {PAD}", padded_gm(g, PAD), 1.5, 1.5, 0)
              for name, g in cs.edge_mixtures(torch, GMState, rng, dev)]
    return [("merge2d", *c) for c in cases]


def vp_merge_input(dev):
    """The merge input of Victoria Park RB-PHD's frame
    ``chip_smoke.VP_FRAMES`` (chip_smoke's stream, filter and seed), and
    the filter's threshold and inflation."""
    vp_plain, _, vp_cfg = cs.vp_streams()
    filt, icov, ack = vp_app.build(XmlConfig(vp_cfg), device=dev)
    stream = vp_io.load(vp_plain, z_capacity=vp_app.Z_CAPACITY, ackerman=ack)
    gen = torch.Generator(device=dev).manual_seed(0)
    state, _ = vp_app.run(filt, icov, vp_app.head(stream, cs.VP_FRAMES), gen)
    g = cs.vp_merge_input(torch, gm_ops, filt, state, stream, cs.VP_FRAMES,
                          dev)
    return g, filt.cfg.merge_threshold, filt.cfg.merge_inflation


def merge3d_cases(dev, rng, vp_in):
    """(kernel, name, mixture, threshold, inflation, calls timed, 0 for
    none) of merge3d's cases; the first two are the Victoria Park input
    and the same padded."""
    g, thr, infl = vp_in
    mix = lambda P, N, n_alive, **kw: cs.random_mixtures3(
        torch, GMState, rng, P, N, dev, n_alive, **kw)
    N = 53248
    cases = [(f"VP frame {cs.VP_FRAMES} merge input P=100 N=512 (small "
              f"form)", g, thr, infl, 25),
             (f"VP frame {cs.VP_FRAMES} merge input padded to {PAD}",
              padded_gm(g, PAD), thr, infl, 25)]
    for n in (1025, PAD):
        cases += [(f"random P=16 N={n}", mix(16, n, (n // 2, n)), 1.5, 1.5,
                   25),
                  (f"every slot alive P=16 N={n}", mix(16, n, (n, n)), 1.5,
                   1.5, 25)]
    cases += [(f"random P={p} N=8192 (gate fields in the workspace)",
               mix(p, 8192, (4096, 8192)), 1.5, 1.5, 5) for p in (2, 100)]
    cases.append((f"random P=1 N={N} (all in the workspace)",
                  mix(1, N, (N - N // 8, N), spread=0.4 * N ** 0.5), 1.5,
                  1.5, 3))
    cases += [(f"{name} padded to {PAD}", padded_gm(e, PAD), 1.5, 1.5, 0)
              for name, e in cs.edge_mixtures3(torch, GMState, rng, 100, 512,
                                               dev)]
    return [("merge3d", *c) for c in cases]


def timed(call, n=25, order=("old", "new", "new", "old")):
    times = {v: [] for v in order}
    for v in order:
        times[v].append(cs.cuda_ms(torch, call[v], n=n,
                                   warmup=1 if n < 25 else 3))
    return times, {v: statistics.median(t) for v, t in times.items()}


def passes(g, thr, infl):
    return (cs.merge_passes(gm_ops, g, thr, infl, cs.MERGE_TRACE_CHUNK)
            if g.w.shape[1] <= TRACE_SLOTS else None)


def sweep_ab(vers, cases, stream):
    """The new merge3d's two-row sweep against the one-row sweep: bits,
    then times in turns (one, two, two, one)."""
    for k, name, g, thr, infl, n_timed in cases:
        two = vers["new"].merge(k, g, thr, infl, stream)
        one = vers["one"].merge(k, g, thr, infl, stream)
        torch.cuda.synchronize()
        call = {"two": lambda: vers["new"].merge(k, g, thr, infl, stream),
                "one": lambda: vers["one"].merge(k, g, thr, infl, stream)}
        ms, med = timed(call, n_timed, ("one", "two", "two", "one"))
        print(json.dumps({"study": "merge3d sweep, one row / two rows a "
                          "warp", "case": name,
                          "bit_equal": bit_equal(one, two), "ms": ms,
                          "median_ms": med}), flush=True)
        if not bit_equal(one, two):
            raise AssertionError(f"merge3d sweep A/B {name}: the builds "
                                 f"differ")


def clock_split(libs, vers, case, stream):
    """Each build's cycles a phase (thread 0 of each CTA, the mean over
    the CTAs) on one call of ``case``, after one untimed call."""
    _, name, g, thr, infl, _ = case
    P = g.w.shape[0]
    for ver in ("old", "new"):
        v = vers[f"{ver}_clk"]
        lib = libs[f"{ver}_clk", "merge3d"][0]
        buf = np.zeros((P, 8), np.uint64)
        for _ in range(2):
            v.merge("merge3d", g, thr, infl, stream)
            torch.cuda.synchronize()
            err = lib.merge3d_clock(vp(buf.ctypes.data), ctypes.c_int(P))
            if err != 0:
                raise RuntimeError(f"merge3d_clock: CUDA error {err}")
        cyc = buf[:, :5].astype(np.float64).mean(axis=0)
        print(json.dumps({
            "study": "merge3d clock64 split", "version": ver, "case": name,
            "passes_mean": float(buf[:, 5].mean()),
            "cycles": dict(zip(CLOCK_PHASES, cyc.tolist())),
            "share": dict(zip(CLOCK_PHASES, (cyc / cyc.sum()).tolist()))}),
            flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True,
                    help="directory holding the earlier rfs_slam_tpu_torch/"
                         "csrc and ops/kernels")
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    old_dir = os.path.abspath(args.old)
    old_csrc = os.path.join(old_dir, "rfs_slam_tpu_torch", "csrc")
    new_csrc = os.path.join(ROOT, "rfs_slam_tpu_torch", "csrc")
    jobs = [(v, k, os.path.join(d, f"{k}.cu"), d) for v, d in (
        ("old", old_csrc), ("new", new_csrc)) for k in KERNELS]
    new3 = os.path.join(new_csrc, "merge3d.cu")
    jobs.append(("one", "merge3d", edited(new3, "one", [ONE_ROW_EDIT]),
                 new_csrc))
    for ver, d in (("old", old_csrc), ("new", new_csrc)):
        src = os.path.join(d, "merge3d.cu")
        with open(src) as f:
            form = "mask-free" if "merge3d_large(" in f.read() else "mask"
        start, edits = CLOCK_EDITS[form]
        jobs.append((f"{ver}_clk", "merge3d", edited(
            src, f"{ver}_clk", edits, start, CLOCK_PRELUDE), d))
    libs = build_all(jobs)
    with open(os.path.join(old_csrc, "map_update2d.cu")) as f:
        old_abi = "int* stats" in f.read()
    old_plans = {k: plan_module(old_dir, k) for k in KERNELS}
    new_plans = {"merge2d": mg, "merge3d": m3, "map_update2d": mu}
    vers = {"old": Version(libs, "old", old_plans, old_abi),
            "new": Version(libs, "new", new_plans),
            "one": Version(libs, "one", new_plans),
            "old_clk": Version(libs, "old_clk", old_plans),
            "new_clk": Version(libs, "new_clk", new_plans)}
    rng = np.random.default_rng(12)
    mu_cases, mid, over = map_update_cases(dev, rng)
    for name, a, is_timed in mu_cases:
        stats = torch.zeros(3, dtype=torch.int32, device=dev)
        new = vers["new"].map_update(a, stream, stats)
        old = vers["old"].map_update(a, stream)
        torch.cuda.synchronize()
        equal = bit_equal(old, new)
        P, M, Zc, T = a[6].shape[0], a[6].shape[1], a[9].shape[0], a[12]
        rec = {"kernel": "map_update2d", "case": name, "bit_equal": equal,
               "ntab_max": int(stats[0]), "stash_in_workspace": int(stats[1]),
               "chunks_max": int(stats[2]),
               "plan_new": mu.launch_plan(P, M, Zc, T, build.sm_count(
                   dev))._asdict(),
               "plan_old": vers["old"].plans["map_update2d"].launch_plan(
                   P, M, Zc, T)._asdict()}
        if is_timed:
            call = {v: (lambda v=v: vers[v].map_update(a, stream))
                    for v in ("old", "new")}
            rec["ms"], rec["median_ms"] = timed(call)
        print(json.dumps(rec), flush=True)
        if not equal:
            raise AssertionError(f"map_update2d {name}: the builds differ")
    m3_cases = merge3d_cases(dev, rng, vp_merge_input(dev))
    for k, name, g, thr, infl, n_timed in (
            merge2d_cases(dev, rng, mid, over) + m3_cases):
        old = vers["old"].merge(k, g, thr, infl, stream)
        new = vers["new"].merge(k, g, thr, infl, stream)
        torch.cuda.synchronize()
        equal = bit_equal(old, new)
        P, N = g.w.shape
        rec = {"kernel": k, "case": name, "bit_equal": equal,
               "alive": int(g.alive.sum()), "alive_after": int(new[1].sum()),
               "passes": passes(g, thr, infl),
               "plan_new": new_plans[k].launch_plan(P, N)._asdict(),
               "plan_old": old_plans[k].launch_plan(P, N)._asdict()}
        if n_timed:
            call = {v: (lambda v=v: vers[v].merge(k, g, thr, infl, stream))
                    for v in ("old", "new")}
            rec["ms"], rec["median_ms"] = timed(call, n_timed)
        print(json.dumps(rec), flush=True)
        if not equal:
            raise AssertionError(f"{k} {name}: the builds differ")
    # the padded Victoria Park input and N=8,192 (P=2, P=100)
    sweep_ab(vers, [m3_cases[1]] + [c for c in m3_cases
                                     if "N=8192" in c[1]], stream)
    clock_split(libs, vers, m3_cases[1], stream)
    for (ver, k), (_, regs) in sorted(libs.items()):
        print(f"{ver} {k}: {regs}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
