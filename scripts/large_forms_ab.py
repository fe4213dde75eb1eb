"""The large forms (M, N > 1,024 slots) of ``map_update2d`` and ``merge2d``
against an earlier version of their sources, on one card in one process.

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
* ``merge2d``: random mixtures at P=200, N=1,025; the mid-run state's
  merge input padded to 2,048; the overflow step's merge input (P=64,
  N=8,192); past the slots whose fixpoint data fits in shared memory,
  random mixtures spread to a few gated neighbours a slot at P=2,
  N=12,288 (the gate fields in the workspace) and P=1, N=53,248 (all in
  the workspace), timed over fewer calls; and, not timed, every slot
  alive at N=2,048 and ``chip_smoke``'s edge mixtures (chains across
  words, every slot alive, N=100, an empty particle) padded to 2,048.

For the new ``map_update2d`` each case prints the kernel's own counts: the
largest number of a particle's table slots, the particles whose stash went
to the workspace and the most table chunks of one; for ``merge2d`` the
passes of the fixpoint (the twin's, a few particles at a time on the
alive prefix, up to 16,384 slots) and both plans' workspaces.  One JSON
line a case, then each build's ptxas report and the card's name and
power limit.

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
from rfs_slam_tpu_torch.apps import sim2d_common as loop  # noqa: E402
from rfs_slam_tpu_torch.core.state import GMState  # noqa: E402
from rfs_slam_tpu_torch.io import sim2d  # noqa: E402
from rfs_slam_tpu_torch.ops import gm as gm_ops  # noqa: E402
from rfs_slam_tpu_torch.ops.kernels import build  # noqa: E402
from rfs_slam_tpu_torch.ops.kernels import map_update2d as mu  # noqa: E402
from rfs_slam_tpu_torch.ops.kernels import merge2d as mg  # noqa: E402

KERNELS = ("merge2d", "map_update2d")
LIB_DIR = os.path.join(ROOT, "build", "ab", "lib")
PAD = 2048
OVERFLOW = (64, 8192, 16)
# P, N, what goes to the workspace: merge2d past the slots whose fixpoint
# data fits in shared memory
WORKSPACE_CASES = ((2, 12288, "gate fields"), (1, 53248, "all"))
TRACE_SLOTS = 16384   # the most slots whose twin trace gives the passes
vp = ctypes.c_void_p


def plan_module(old_dir, k):
    """The earlier wrapper module of kernel ``k`` (its launch_plan)."""
    path = os.path.join(old_dir, "rfs_slam_tpu_torch", "ops", "kernels",
                        f"{k}.py")
    spec = importlib.util.spec_from_file_location(f"old_{k}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_all(srcs):
    """``{(version, kernel): (CDLL, ptxas report)}``, one nvcc each, all
    started together."""
    os.makedirs(LIB_DIR, exist_ok=True)
    procs = []
    for ver, d in srcs.items():
        for k in KERNELS:
            src = os.path.join(d, f"{k}.cu")
            out = os.path.join(LIB_DIR, f"{k}-large-{ver}.so")
            flags = build.NVCC_FLAGS + build.EXTRA_FLAGS.get(k, [])
            procs.append((ver, k, out, subprocess.Popen(
                [build._nvcc(), *flags, "-I", d, "-o", out, src],
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
    """One build of both kernels with its own plans and C entries."""

    def __init__(self, libs, ver, plans, new_abi):
        self.mu_lib = libs[ver, "map_update2d"][0]
        self.mg_lib = libs[ver, "merge2d"][0]
        self.plans = plans
        self.new_abi = new_abi   # map_update2d's stats

    def merge2d(self, gm, thr, infl, stream):
        P, N = gm.w.shape
        plan = self.plans["merge2d"].launch_plan(P, N)
        out = torch.empty((7, P, N), device=gm.w.device)
        alive_o = torch.empty_like(gm.alive)
        ws = build.workspace(plan.workspace, gm.w.device)
        ptrs = [vp(t.data_ptr()) for t in (gm.mean, gm.cov, gm.w, gm.w_prev,
                                           gm.alive, out, alive_o)]
        err = self.mg_lib.merge2d_launch(
            ctypes.c_int(P), ctypes.c_int(N), ctypes.c_int(plan.threads),
            ctypes.c_int(plan.smem), ctypes.c_float(thr * thr),
            ctypes.c_float(infl), ctypes.c_int(8), *ptrs,
            vp(build.ptr(ws)), ctypes.c_size_t(plan.workspace), vp(stream))
        if err != 0:
            raise RuntimeError(f"merge2d launch failed: CUDA error {err}")
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
        err = self.mu_lib.map_update2d_launch(
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


def merge_cases(dev, rng, mid, over):
    """(name, mixture, threshold, inflation, calls timed, 0 for none) of
    the merge's cases."""
    filt, state, z, z_mask = mid
    full = filt._map_update(state, z, z_mask)[0]
    merge_in = gm_ops.compact(full, full.capacity)
    thr, infl = filt.cfg.merge_threshold, filt.cfg.merge_inflation
    pad = GMState(*[padded(x, PAD) for x in (
        merge_in.mean, merge_in.cov, merge_in.w, merge_in.w_prev,
        merge_in.alive)])
    ofilt, ostate, oz, ozm = over
    ofull = ofilt._map_update(ostate, oz, ozm)[0]
    omerge = gm_ops.compact(ofull, ofull.capacity)
    cases = [("random P=200 N=1025", cs.random_mixtures(
                 torch, GMState, rng, 200, 1025, dev, (500, 1025)), 1.5, 1.5,
              25),
             (f"mid-run merge input padded to {PAD}", pad, thr, infl, 25),
             (f"overflow merge input P={OVERFLOW[0]} N={OVERFLOW[1]}", omerge,
              ofilt.cfg.merge_threshold, ofilt.cfg.merge_inflation, 25)]
    for P, N, tier in WORKSPACE_CASES:
        cases.append((f"random P={P} N={N} ({tier} in the workspace)",
                      cs.random_mixtures(torch, GMState, rng, P, N, dev,
                                         (N - N // 8, N), 0.4 * N ** 0.5),
                      1.5, 1.5, 5))
    cases.append(("every slot alive N=2048", cs.random_mixtures(
        torch, GMState, rng, 16, PAD, dev, (PAD, PAD)), 1.5, 1.5, 0))
    cases += [(f"{name} padded to {PAD}", GMState(*[padded(x, PAD) for x in (
        g.mean, g.cov, g.w, g.w_prev, g.alive)]), 1.5, 1.5, 0)
              for name, g in cs.edge_mixtures(torch, GMState, rng, dev)]
    return cases


def timed(call, n=25):
    times = {"old": [], "new": []}
    for v in ("old", "new", "new", "old"):
        times[v].append(cs.cuda_ms(torch, call[v], n=n))
    return times, {v: statistics.median(t) for v, t in times.items()}


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
    libs = build_all({"old": old_csrc, "new": os.path.join(
        ROOT, "rfs_slam_tpu_torch", "csrc")})
    with open(os.path.join(old_csrc, "map_update2d.cu")) as f:
        old_abi = "int* stats" in f.read()
    vers = {"old": Version(libs, "old", {k: plan_module(old_dir, k)
                                         for k in KERNELS}, old_abi),
            "new": Version(libs, "new", {"merge2d": mg, "map_update2d": mu},
                           True)}
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
    for name, g, thr, infl, n_timed in merge_cases(dev, rng, mid, over):
        old = vers["old"].merge2d(g, thr, infl, stream)
        new = vers["new"].merge2d(g, thr, infl, stream)
        torch.cuda.synchronize()
        equal = bit_equal(old, new)
        P, N = g.w.shape
        rec = {"kernel": "merge2d", "case": name, "bit_equal": equal,
               "alive": int(g.alive.sum()),
               "alive_after": int(new[1].sum()),
               "passes": (cs.merge_passes(gm_ops, g, thr, infl,
                                          cs.MERGE_TRACE_CHUNK)
                          if N <= TRACE_SLOTS else None),
               "plan_new": mg.launch_plan(P, N)._asdict(),
               "workspace_old": vers["old"].plans["merge2d"].launch_plan(
                   P, N).workspace}
        if n_timed:
            call = {v: (lambda v=v: vers[v].merge2d(g, thr, infl, stream))
                    for v in ("old", "new")}
            rec["ms"], rec["median_ms"] = timed(call, n_timed)
        print(json.dumps(rec), flush=True)
        if not equal:
            raise AssertionError(f"merge2d {name}: the builds differ")
    for (ver, k), (_, regs) in sorted(libs.items()):
        print(f"{ver} {k}: {regs}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
