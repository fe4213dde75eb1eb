#!/usr/bin/env python3
"""Drive the PyTorch port's SLAM paths once on one NVIDIA GPU: RB-PHD (the
2-D replay, Victoria Park), FastSLAM 1.0 and MH-FastSLAM.

Phases (any failure raises and exits non-zero; nothing is caught):

1. print the card's name and power limit;
2. build the four CUDA kernels from ``rfs_slam_tpu_torch/csrc``, one nvcc
   each, all started together, and print each ptxas report;
3. ``map_update2d``: kernel against its plain twin at the bench shape
   (P=200, M=128, Zc=40) on a mid-run state of the ``native/bl_dump``
   replay, with that replay's measurements, and on edge inputs cut from it
   (a crowded map, T=1, negative weights, tied values, sparse columns and
   an empty particle, M=100, Zc=1, M=300 and M=1024);
3b. ``map_update2d``'s block form (the particles x map mesh's: a head and
   a tail launch per block of slots, the column sums combined in block
   order, the picks merged) on the same mid-run state in two blocks of 64
   slots, against its twin and against the one launch (unused flags and
   positive picks equal), and the device time of one block's two launches
   beside its twins' and their bound (``map_update_bound`` on the block's
   inputs and the head's and tail's outputs);
4. ``merge2d``: kernel against its plain twin on random mixtures with
   20-120 alive slots, on the same mid-run state, and on edge mixtures
   (gated chains across 32-slot words, every slot alive, N=100, a
   particle with no alive slot), with the maximum absolute error of each;
4b. ``merge3d``: kernel against its plain twin at Victoria Park's width
   (P=100, N=512) on the merge input of the synthetic Victoria Park stream
   after 200 frames, on random 3-D mixtures with 40-400 alive slots (several
   passes) and on edge mixtures (gated chains across 32-slot words, every
   slot alive, N=100, N=1024, a particle with no alive slot, a gated pair
   of zero weight), with the maximum absolute error of each;
5. the full bench-configuration replay of ``native/bl_dump`` (3,000 steps,
   P=200) through both 2-D kernels: launch counts, finite outputs, and the
   median pose error within a divergence bound of 0.3 m (bench gate 0.12 m);
5c. the Victoria Park path (P=100, M=512, Zc=24, 3-D maps, the
   birth-candidate state machine) over the first 2,000 of the synthetic
   stream's 7,230 frames (seed 0, no scans; depth cut to fit the call):
   ``merge3d`` launches once per frame with measurements, finite outputs,
   and the trajectory RMSE against the stream's GPS below dead
   reckoning's and within a divergence bound;
5d. ``merge3d`` checked and timed on the merge input of frame 2,000, the
   state 5c ends in, with its alive slots per particle, passes and merged
   pairs;
5e. 200 frames of a stream with lidar scans (the scan-dependent Pd);
7. FastSLAM 1.0 through ``fastslam2dsim.run``'s step loop at full width
   (P=200, M=128, NMZ=32, candidate capacity 16; the stand-in
   ``fastslam2dSim.xml`` of ``io/sim2d_xml.py``) on
   ``sim2d.generate(traj_seed=1, noise_seed=1)``, all 3,000 steps, with
   torch's sync debug mode raising on any read-back inside the loop:
   steps/s, the median best-particle position error over steps >= 150
   beside dead reckoning's, which it must beat; the ``hungarian`` kernel
   launches once per update with measurements; generator seeds 1-15
   (the same run, other draws) run later in the seed workers, beside
   phases 10 and 13, and must beat dead reckoning too, and the median of
   the 16 errors is held to a divergence bound set from the JAX
   package's runs;
8. MH-FastSLAM the same way (H=3, P=200 live of P_cap=600, child cap 6,
   lane budget 200) over the first 2,000 steps (the depth cut), four
   launches an update (the gated root, Murty's root and two waves), with
   seeds 1-3 beside seed 0 for its bound; then one more update with the
   kernel's inputs recorded;
11. Victoria Park FastSLAM 1.0 through ``fastslam_victoriapark.run`` at
   the app's width (P=200, M=512, Zc=24, NMZ=32) over the first 2,000 of
   the seed-0 synthetic stream's 7,230 frames (no scans; depth cut to fit
   the call), in chunks of 500 frames, each under torch's sync debug mode
   set to raise: frames/s, the RMSE against the GPS beside dead
   reckoning's, ``hungarian`` launches (one for each frame with
   measurements) and the best particle's alive landmarks; generator seeds
   1-7 run later in the seed workers, beside phases 10 and 13, and
   the median RMSE of the eight runs is held below dead reckoning's and
   within a divergence bound from the JAX package's runs (section 6 of
   PERF.md);
12. MH-FastSLAM the same way (H=3, 200 live of 600, lane budget 200) over
   the first 500 frames, four launches for each frame with measurements,
   generator seeds 1-7 beside seed 0 for its bound;
9. ``hungarian``: kernel against its plain twin, ``row_to_col`` equal and
   ``u``, ``v``, ``total`` equal to the bit, on random batches at (B, n) =
   (200, 32), (600, 32), (1200, 32), the DA tables of step 1,500 of phase
   7 and of frame 2,000 of phase 11 (D=3, on its final state), the
   matrices of phase 8's recorded update (the Murty waves' with
   their NEG bans), all-equal matrices, a NEG row and column, -0.0 and
   +0.0 tied in rows, B=1, rows and columns below -INF, n = 1, 31, 33, 52
   (batchsim's NMZ), 63, 64, 128 and 200, and n = 241, 300 and 1024, whose
   matrices do not fit shared memory (every instantiation of the kernel);
   timed on the DA tables, its bound from the twin's trip counts, and the
   time of one search trip of the slowest matrix (``ns_per_trip``);
10. ``batchsim.run_one`` on the card, one 300-step cell of each filter kind
   (clutter 1e-3, measurement capacity 48: NMZ 52): finite errors and COLA;
13. resume on the card, for both Victoria Park apps at their widths: a
   300-frame run against one cut after a 150-frame chunk and resumed from
   its snapshot in a temporary directory; outputs and final state equal
   bit for bit (floats as int32 views), with the frames where the run was
   cut and resumed;
14. the library on the card, on phase 11's final state (after 2,000 frames:
   the best particle's pose and map, M=512, D=3) and the 2,000th frame's
   measurements (Zc=24, the last frame the state saw) through the Victoria
   Park model: (a) ``jcbb_block_diag`` at that width, beam 32, under
   torch's sync debug mode set to raise: assoc and n_paired equal to the
   same call on CPU copies, md2 within 1e-5 relative; on a cut (the first
   12 measurements, the 64 alive landmarks nearest the vehicle) its assoc
   equal to the dense ``jcbb``'s on the card; the median of 25 CUDA-event
   timings, and its peak device memory above its inputs (at most 64 MiB);
   (b) ``spatial.build`` over the map's alive landmarks in x-y,
   ``query_box`` around the vehicle equal to brute force, ``nearest`` of
   each measurement's inverse-projected point equal to brute force's
   distances (within 1e-6 relative) and indices (where its minimum is
   unique), timed; (c) the five examples' ``main`` on the card, each
   validating itself, with the ``hungarian`` launches of the Murty and
   partition examples; (d) the native writers (``io/native.py`` over
   ``native/rfsio.cpp``, built here) against the Python writers on phase
   7's logged run (3,000 steps x 200 particles and the best map),
   byte-equal, each writer's host seconds;
15. four paths sharded over the most ranks of 4, 2 and 1 that the cards
   hold (P=200, P=100 and P_cap=600 split evenly over each; 3 would not),
   one process a card over NCCL (``parallel/mesh.py``, driven by
   ``parallel/dryrun.py``), each against its unsharded run in this
   process: the ``native/bl_dump`` replay (P=200, M=128, Zc=40),
   FastSLAM 1.0 on ``sim2d`` (P=200, M=128, NMZ=32) and MH-FastSLAM (H=3,
   200 live of P_cap=600, lane budget 200), 160 steps each (the 100-step
   ground-truth lock, then 60 free steps), and Victoria Park RB-PHD
   (P=100, M=512, Zc=24, D=3), 60 frames, every loop under torch's sync
   debug mode set to raise; then the replay on the particles x map mesh:
   on four cards a 2 x 2 NCCL mesh, on one card a 1 x 1 NCCL mesh (160
   steps, bit-equal to the unsharded run) and a 1 x 2 mesh of two gloo
   ranks sharing the card; each 2-rank map mesh teacher-forced (140 free
   steps, then 20 steps each from the unsharded state with the same
   draws, every integer and bool field equal and the floats within
   ``test_sharding.py``'s one-step tolerances, ``dryrun.
   compare_states``); on a machine with one card,
   again over two ranks sharing it through gloo (NCCL refuses a card
   twice; gloo's collectives wait on the host, so without the sync
   check); ``parent``, the resampling flags and every integer and bool
   field of the final state equal, pose, ``log_w`` and ``w`` within
   ``test_sharding.py``'s multistep tolerances, every other float field
   within 1e-4 (relative above 1); one JSON line a path and run (ranks,
   mesh, backend, devices, launches and collectives a step, the bytes each
   rank receives a step, steps/s sharded beside unsharded, resamples,
   ancestors taken from another rank); ``map_update2d`` launches twice an
   update under a map mesh (head and tail), every other kernel as often
   as unsharded;
16. large maps, the kernels' large forms (M or N above 1,024 slots):
   (1) each against its twin on random states (M, N = 1,025 and 2,048 at
   P=16 and 8,192 at P=2; the merges also with every slot alive at
   N=2,048; ``merge2d`` also at 10,000 slots; each merge launch with its
   tier, where its fixpoint data lies, and its workspace bytes:
   ``merge3d``'s in shared memory up to 5,756 slots, its gate fields in
   the workspace at 8,192) and the block form as head and tail on two
   blocks of 2,048 of M=4,096 against its twin and the one launch, with
   the kernel-against-twin tolerances of phases 3, 4 and 4b; (2) phase
   3's mid-run state and merge input and phase 5d's Victoria Park merge
   input padded with dead slots to 2,048: on their slots the large
   forms' outputs equal the small forms' to the bit (every plane, the
   column sums, the unused flags, the alive sets, every positive pick and
   its weight), each form
   timed there beside its twin and bound; (3) ``map_overflow_demo``'s card
   mode at P=64, M=8,192, Zc=16 for 20 steps under the sync debug mode,
   both 2-D kernels in their large form once a step, its peak device
   memory beside the JAX script's analytic figures, and each large form
   timed at that shape beside its bound (the merge's operations traced
   a few particles at a time on the alive prefix), with the merge's
   passes and workspace and the map update's own counts (its most table
   slots of a particle, the particles whose stash went to the workspace,
   the most table chunks); the padded states print the same counts; then
   the large forms' times beside those recorded before their redesign;
   (4) the ``bl_dump`` replay with maps of 2,048
   slots (P=200, Zc=40), its first 500 steps: launches, finite outputs,
   steps/s beside phase 5's and the median pose error (no gate); (5) 100
   frames of Victoria Park RB-PHD with maps of 2,048 slots, ``merge3d``'s
   large form once a frame with measurements; (6) the dry run's replay at
   2,048 slots on a 1 x 2 gloo map mesh sharing the card, 20 steps
   teacher-forced after 20, against the unsharded run;
17. the weak-scaling harness (``parallel/scaling_bench.py``) at small
   depth: the example step (8 particles a rank, M=64, Zc=8, 3 steps) on
   the particle mesh over 1, 2 and 4 NCCL ranks where the cards hold them
   and over two gloo ranks sharing one card, each against the one-rank
   run at the same total P (``parent`` and ``alive`` equal, ``log_w`` and
   the poses within the multistep tolerances); ``map_update2d`` and
   ``merge2d`` launch in every rank as often a step as in the one-rank
   run; one JSON line an n;
6. with ``--gates``: the 4-seed simulation median (trajectory seed 1,
   generator seeds 1-4) against the bench gate of 0.15 m.

Each path phase (5, 5c, 7, 8, 11, 12) resets the card's peak-memory
counters before its run, then checks its final map with
``utils/integrity.check_map_integrity`` (log-odds weights for FastSLAM),
which must be clean, and prints the run's peak device memory from
``utils/memprofile.device_memory`` (one ``path_check`` line each).

Each kernel's ``ms`` beside its twin's ``plain_ms`` is the median device
time of 25 calls at its path's shape (see :func:`cuda_ms`); ``bound_ms``
is the least time the card could take for the same work on this run's
inputs (see :func:`bound`), and ``floor_ms`` the same timing around a
one-element ``zero_()``: what the event pair reads for the smallest
launch.  Prints the kernel table (the four kernels, then the three large
forms, timed on the padded mid-run states), then the card, then the
contract line ``{"ok": true, "device": {...}}`` last.  Usage:
``python3 chip_smoke.py [--gates]`` from the repository root.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BL_DUMP = os.path.join(HERE, "native", "bl_dump")
MIDRUN_STEPS = 60
DIVERGENCE_BOUND_M = 0.3
REPLAY_GATE_M = 0.12       # bench.py IDENTICAL_DATA_ANCHOR_M
SEED_MEDIAN_GATE_M = 0.15  # bench.py ACCURACY_ANCHOR_M
QUEUE_SPIN_CYCLES = 40_000_000  # ~20 ms of a ~2 GHz SM clock
VP_DIR = os.path.join(HERE, "build", "vp_synth")
VP_FRAMES = 2000           # of the stream's 7,230: the depth cut
VP_MIDRUN_FRAMES = 200
VP_SCAN_FRAMES = 200
# The JAX package on the same 2,000 frames on the CPU at P=32 (keys 0-5,
# scripts/vp_synth_jax_rmse.py): 2.13-3.81 m on the four keys that held the
# track, 14.9 and 28.1 m on two that lost it; dead reckoning 5.47 m.  The
# bound is the largest RMSE of a run that held the track, rounded up.
VP_DIVERGENCE_BOUND_M = 4.0
FS_STEPS = 3000            # FastSLAM 1.0: the whole run
MH_STEPS = 2000            # MH-FastSLAM: the depth cut (of 3,000)
# Divergence bounds from the JAX package on the same data and config on the
# CPU at P=200 (scripts/fastslam2d_jax_err.py; PERF.md, section 6).  One run
# is one draw of a chaotic process, so each bound holds the median of the
# main path's run (generator seed 0) and more seeds, and is the largest
# median of JAX's keys in groups of as many, rounded up at its first
# significant digit.  FastSLAM 1.0: keys 0-47 in groups of 16, medians
# 0.124, 0.137, 0.166 m (a 4-seed median fails JAX's own keys 10% of the
# time at 0.2 m; a 16-seed one 1.6%).  MH-FastSLAM over 2,000 steps: keys
# 0-3, median 0.154 m.
FS_DIVERGENCE_BOUND_M = 0.2
MH_DIVERGENCE_BOUND_M = 0.2
FS_BOUND_SEEDS = tuple(range(1, 16))  # beside the main path's seed 0
MH_BOUND_SEEDS = (1, 2, 3)
FS_MID_STEP = 1500         # the DA tables checked and timed
# Victoria Park FastSLAM (phases 11-13) on the seed-0 synthetic stream at
# the app's width (P=200, M=512, Zc=24, NMZ=32).  Bounds from the JAX
# package's app on the same frames on the CPU at the same width
# (scripts/vp_fastslam_jax_rmse.py; PERF.md, section 6), by the rule of
# phases 7-8: the largest median of JAX's keys in groups of as many runs
# as the port's seeds, rounded up at its first significant digit.
VP_FS_FRAMES = 2000        # of 7,230: the depth cut
VP_MH_FRAMES = 500         # MH-FastSLAM's depth cut
VP_FS_BOUND_SEEDS = tuple(range(1, 8))   # beside the main path's seed 0
VP_MH_BOUND_SEEDS = tuple(range(1, 8))
# processes running the bounds' other seeds (2-D and VP, one task a
# seed), beside phases 10 and 13, which hold no time to a bound
SEED_WORKERS = 7
# FastSLAM 1.0: JAX keys 0-31 in groups of 8, medians 0.857, 1.700, 0.612,
# 1.541 m (a random 8-key median exceeds 2.0 m 3.8% of the time).
VP_FS_DIVERGENCE_BOUND_M = 2.0
# MH-FastSLAM (500 frames): keys 0-31 in groups of 8, medians 0.595, 0.454,
# 0.730, 1.281 m (a random 8-key median exceeds 2.0 m 0.026% of the time).
VP_MH_DIVERGENCE_BOUND_M = 2.0
VP_FS_CHUNK = 500          # frames a chunk of the chunked run
VP_RESUME_FRAMES = 300     # phase 13: a run cut after half of these
# phase 15: the 2-D paths' 100-step ground-truth lock, then 60 free steps
SHARDED_PATHS = (("replay", 160), ("vp", 60), ("fastslam", 160),
                 ("mh", 160))
# phase 15's map mesh: the replay's 160 steps; teacher-forced, 140 free
# steps then 20 held one by one
MAP_PATH = ("replay", 160)
MAP_TEACHER = (140, 20)
MAP_BLOCKS = 2     # slot blocks of the block form's direct check (3b)
SHARDED_TIMEOUT_S = 300
# rank counts that split every sharded path's particles (200, 100) evenly
SHARDED_RANKS = (4, 2, 1)
VP_FS_TABLE_FRAME = VP_FS_FRAMES  # the DA tables phase 9 checks
# phase 14: the library on phase 11's final state
JCBB_BEAM = 32
LIBRARY_FRAME = VP_FS_FRAMES - 1   # the last frame phase 11's state saw
JCBB_CUT = (12, 64)        # (measurements, nearest landmarks) of the cut
JCBB_PEAK_LIMIT = 64 * 2**20
SPATIAL_CELL_M = 5.0
SPATIAL_BOX_M = 30.0       # half-width of the box query around the vehicle
# f32 operations a search trip needs on each column: an unused one its
# reduced cost (2), its compare with minv (1), the argmin (1) and minv's
# step (1); a used one v's step (1) and its row's u (1)
HUNGARIAN_FLOP_UNUSED = 5
HUNGARIAN_FLOP_USED = 2
# phase 16: the large forms (M or N above 1,024 slots)
LARGE_TWIN_SHAPES = ((16, 1025, 40), (16, 2048, 40), (2, 8192, 16))
LARGE_BLOCKS = (16, 4096, 2)   # P, M, blocks of the block form's check
# P, N, half-width of the means: merge2d's gate fields in its workspace,
# a few gated neighbours a slot (chains, several passes)
LARGE_WS_TWIN = (1, 10_000, 40.0)
LARGE_PAD = 2048               # the padded mid-run states' slots
OVERFLOW = (64, 8192, 16, 20)  # P, M, Zc, steps: the overflow demo's shape
LARGE_REPLAY = (2048, 500)     # map slots, steps of the bl_dump replay
LARGE_VP = (2048, 100)         # map slots, frames of VP RB-PHD
LARGE_MESH = (2048, 20, 20)    # map slots, free and teacher-forced steps
MERGE_TRACE_CHUNK = 8          # particles a merge trace takes at a time
# phase 17: particles a rank, map slots, Zc, steps of the weak-scaling run
SCALING = (8, 64, 8, 3)
# the large forms' times recorded before their redesign (phase 16 on an
# NVIDIA H100 80GB HBM3 at 700 W), printed beside this run's: padded to
# LARGE_PAD slots, and at the overflow shape
PARENT_LARGE_MS = {"map_update2d": (0.067808, 0.95731),
                   "merge2d": (0.044768, 17.110), "merge3d": (0.043040, None)}
T_LOADED = time.perf_counter()   # what elapsed() counts from
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, f32 FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12


def elapsed(what: str) -> None:
    """Print the seconds since this module was loaded, after ``what``:
    where the call's time limit goes."""
    print(f"elapsed: {time.perf_counter() - T_LOADED:.1f} s after {what}",
          flush=True)


def cuda_ms(torch, fn, n: int = 25, warmup: int = 3,
            queued: bool = True) -> float:
    """Median over ``n`` calls of ``fn`` of the time between CUDA events
    recorded around each call.

    ``queued``: the stream is first held busy (~20 ms spin), so the host
    has issued the whole call before the card reaches the start event and
    the pair spans the call's device work only; a call that waits on the
    device (the merge twin syncs once per pass) still includes its host
    stalls.  Without it the pair also spans the host's issue time, as a
    filter step sees it.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(QUEUE_SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_vs_twin_ms(torch, name, kernel, twin):
    """Queued (device) times of the kernel and its twin, and their call
    times, printed; returns the queued pair."""
    ms, plain_ms = cuda_ms(torch, kernel), cuda_ms(torch, twin)
    call_ms = cuda_ms(torch, kernel, queued=False)
    plain_call_ms = cuda_ms(torch, twin, queued=False)
    print(f"{name}: device ms {ms:.4f} (twin {plain_ms:.4f}); call ms "
          f"{call_ms:.4f} (twin {plain_call_ms:.4f})", flush=True)
    return ms, plain_ms


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: int, n_flop: float):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the f32 operations over the card's f32 rate."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flop / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def map_update_bound(args, out):
    """Every input read once and every output written once, over every
    slot (dead and padded ones too); the operations this input needs: per
    alive slot (measure, H, S, its inverse, K, the updated covariance: ~60
    FLOP), per cell of a valid measurement and a table slot, one alive,
    detectable and in range (innovation, angle wrap, quadratic form,
    likelihood, gates, weight and its normalisation: ~27 FLOP), and the
    iterated per-column argmax over the table's slots (2 per slot and
    pass).  Every other cell is zero by the rules and needs no
    operation."""
    alive, z_mask, params, T = args[8], args[10], args[11], args[12]
    r_max, r_min = params[0], params[1]
    r = out.z_exp[0]
    table = alive & (out.pd > 0) & (r >= r_min) & (r <= r_max)
    ins = [a for a in args[:11]]
    outs = [out.pd, out.col_sum, out.w, out.w_prev, out.K, out.z_exp,
            out.cov_upd, out.cand_w, out.cand_m, out.unused]
    flop = (int(alive.sum()) * 60
            + int(z_mask.sum()) * int(table.sum()) * (27 + 2 * T))
    return bound(nbytes(*ins) + nbytes(*outs), flop)


def merge_tests(torch, gate, alive, first_i):
    """The gate tests one merge pass needs on this input, per particle
    [P]: a safe row (no gated alive partner below it) tests every alive
    slot below it; an unsafe row one partner, then the safe slots below it
    up to its claim (all of them where it claims none).  ``gate``,
    ``first_i``: the twin's (``ops/gm.py::_merge_pairs``)."""
    N = alive.shape[1]
    safe = alive & ~gate.any(dim=1)
    alive_below = torch.cumsum(alive, 1) - alive.long()
    safe_upto = torch.cumsum(safe, 1)          # safe slots at or below
    claims = torch.where(first_i < N,
                         safe_upto.gather(1, first_i.clamp(max=N - 1)),
                         safe_upto - safe.long())
    tests = torch.where(safe, alive_below,
                        torch.where(alive, 1 + claims, 0))
    return tests.sum(dim=1).double()


def merge_trace(gm_ops, gm, threshold, f_inflation, max_passes=8):
    """The passes of the merge fixpoint as the kernels run them, each
    particle until one of its passes merges nothing, counted with the
    twin's passes: per pass, (the particles still running [P], their alive
    slots [P], the pairs each merged [P], the gate tests it needs [P],
    :func:`merge_tests`)."""
    import torch

    t2 = threshold * threshold
    active = gm.alive.new_ones(gm.alive.shape[0])
    trace = []
    for _ in range(max_passes):
        a = gm.alive.sum(dim=1).double()
        gate, first_i, _ = gm_ops._merge_pairs(gm, t2)
        tests = merge_tests(torch, gate, gm.alive, first_i)
        del gate
        gm, _ = gm_ops._merge_pass(gm, t2, f_inflation)
        merged = a - gm.alive.sum(dim=1).double()
        trace.append((active, a, merged * active, tests))
        active = active & (merged > 0)
        if not bool(active.any()):
            break
    return trace


def alive_prefix(torch, gm, p0, p1):
    """Particles ``p0 .. p1 - 1`` of a compacted mixture, cut after its
    highest alive slot: the same passes and merges as on every slot, with
    pair cubes of that size only."""
    part = type(gm)(gm.mean[:, p0:p1], gm.cov[:, p0:p1], gm.w[p0:p1],
                    gm.w_prev[p0:p1], gm.alive[p0:p1])
    n = int(torch.nonzero(part.alive.any(dim=0)).max()) + 1 if bool(
        part.alive.any()) else 1
    return type(gm)(part.mean[..., :n], part.cov[..., :n], part.w[:, :n],
                    part.w_prev[:, :n], part.alive[:, :n])


def merge_passes(gm_ops, gm, threshold, f_inflation, chunk):
    """The most passes a particle's fixpoint runs (:func:`merge_trace`,
    ``chunk`` particles at a time on their alive prefix)."""
    import torch

    return max(len(merge_trace(gm_ops, alive_prefix(torch, gm, p0,
                                                    p0 + chunk),
                               threshold, f_inflation))
               for p0 in range(0, gm.w.shape[0], chunk))


def merge_bound(gm_ops, gm, out, threshold, f_inflation, inv_flop,
                merge_flop, chunk=None):
    """Every plane read once and written once; the operations of this
    input's passes (:func:`merge_trace`): each pass inverts its alive
    slots' covariances, makes the gate tests the pass needs
    (:func:`merge_tests`: a search that stops at its first hit needs far
    fewer than every pair where much merges) and merges its pairs.  A
    pair's two-way gate needs the D subtractions of v = mu_j - mu_k, the T
    = D(D+1)/2 products of v's entries (shared by both quadratic forms)
    and, per form, T multiplies and T - 1 adds: 31 FLOP at D=3, 15 at D=2
    (its two comparisons are not counted).  ``chunk``: trace that many
    particles at a time on their alive prefix (:func:`alive_prefix`), for
    inputs whose pair cubes would not fit."""
    import torch

    tri = gm.dim * (gm.dim + 1) // 2
    pair_flop = gm.dim + tri + 2 * (2 * tri - 1)
    P = gm.w.shape[0]
    step = chunk or P
    flop = sum(float((active * (a * inv_flop + tests * pair_flop
                                + merged * merge_flop)).sum())
               for p0 in range(0, P, step)
               for active, a, merged, tests in merge_trace(
                   gm_ops, gm if chunk is None else alive_prefix(
                       torch, gm, p0, p0 + step), threshold, f_inflation))
    planes = [gm.mean, gm.cov, gm.w, gm.w_prev, gm.alive]
    out_planes = [out.mean, out.cov, out.w, out.w_prev, out.alive]
    return bound(nbytes(*planes) + nbytes(*out_planes), flop)


def close(name, got, want, rtol, atol, mask=None):
    """Assert ``got`` ~ ``want`` (numpy allclose semantics); returns the max
    absolute error (0 where the two are equal, infinities included)."""
    got = got.detach().cpu().numpy()
    want = want.detach().cpu().numpy()
    if mask is not None:
        got, want = got[..., mask], want[..., mask]
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    with np.errstate(invalid="ignore"):   # inf - inf where both are inf
        diff = np.where(same, 0.0, got - want)
    return float(np.max(np.abs(diff), initial=0.0))


def reset_peak(torch, dev) -> int:
    """Zero the card's peak-memory counters; the bytes allocated now."""
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.memory_allocated(dev)


def path_check(torch, name, gm, log_odds, held, dev):
    """A path's final map through ``check_map_integrity`` (it must be
    clean) and the path's peak device memory since :func:`reset_peak`
    (which returned ``held``), one JSON line."""
    from rfs_slam_tpu_torch.utils import memprofile
    from rfs_slam_tpu_torch.utils.integrity import check_map_integrity

    ok, report = check_map_integrity(gm, weights_are_log_odds=log_odds)
    mem = memprofile.device_memory(dev)
    print(json.dumps({
        "path_check": name, "integrity_ok": ok, **report,
        "peak_bytes_in_use": mem["peak_bytes_in_use"],
        "held_before_bytes": held,
        "peak_above_held_bytes": mem["peak_bytes_in_use"] - held,
        "peak_bytes_reserved": mem["peak_bytes_reserved"]}), flush=True)
    if not ok:
        raise AssertionError(f"{name}: map integrity {report}")


def midrun(torch, app, loop, filt, gen, dt):
    """The bench filter after MIDRUN_STEPS steps of the bl_dump replay,
    predicted to the next step, with that step's measurements."""
    _, inputs = app.load_bl_dump(BL_DUMP, steps=MIDRUN_STEPS + 2)
    head = tuple(a[:MIDRUN_STEPS] for a in inputs)
    state, _ = loop.run(filt, head, gen, dt)
    dev = gen.device
    odo, z, z_mask = (torch.as_tensor(a[MIDRUN_STEPS], device=dev)
                      for a in inputs[:3])
    return filt.predict(state, odo.float(), dt, gen=gen), z, z_mask


def map_update_cases(torch, args):
    """The mid-run inputs and the edge cases the kernel's design hinges on
    (tests/test_torch_map_update.py's, at the path's width): every slot a
    copy of an alive one (more than 64 slots in the table), columns with
    more than T positive cells (T=1), negative weights (both take the
    argmax rounds), tied values, columns with fewer than T positive cells
    and a particle with no alive slot, M=100, Zc=1, and M=300 and M=1024
    (tiled slots: the argmax from shared memory, and at 1024 the table in
    two chunks)."""
    pose, *slots, z, z_mask, params, T = args   # slots: 8 planes [P, M]
    M = slots[0].shape[1]

    def tiled(n):
        return [torch.cat([x] * -(-n // M), dim=1)[:, :n].contiguous()
                for x in slots]

    sparse = slots[-1].clone()
    sparse[:, 3:] = False
    sparse[0] = False
    negative = slots[6].clone()
    negative[:, ::3] *= -1.0
    # every slot a copy of an alive one: more than 64 slots in the table
    n = int(slots[-1].sum(dim=1).min())
    first = torch.argsort((~slots[-1]).int(), dim=1, stable=True)[:, :n]
    crowd = first.repeat(1, -(-M // n))[:, :M]
    k = int(torch.nonzero(z_mask)[0])
    return [
        ("mid-run", args),
        ("crowded", (pose, *[torch.gather(x, 1, crowd) for x in slots], z,
                     z_mask, params, T)),
        ("T=1", (*args[:-1], 1)),
        ("negative weights", (pose, *slots[:6], negative, *slots[7:], z,
                              z_mask, params, T)),
        ("ties", (pose, *[torch.cat([x[:, :M // 2]] * 2, dim=1)
                          for x in slots], z, z_mask, params, T)),
        ("sparse", (pose, *slots[:-1], sparse, z, z_mask, params, T)),
        ("M=100", (pose, *tiled(100), z, z_mask, params, T)),
        ("Zc=1", (pose, *slots, z[k:k + 1], z_mask[k:k + 1], params, T)),
        ("M=300", (pose, *tiled(300), z, z_mask, params, T)),
        ("M=1024", (pose, *tiled(1024), z, z_mask, params, T))]


def compare_map_update(torch, name, k, p):
    """A map update (``k``) against its twin's (``p``): floats within the
    kernel's tolerances, the unused flags and the positive picks equal.
    Returns the maximum absolute error and the positive picks' mask."""
    torch.cuda.synchronize()
    case = [close(f"pd ({name})", k.pd, p.pd, 1e-6, 1e-7),
            close(f"col_sum ({name})", k.col_sum, p.col_sum, 5e-5, 1e-7),
            close(f"w ({name})", k.w, p.w, 5e-5, 1e-7),
            close(f"w_prev ({name})", k.w_prev, p.w_prev, 0, 0),
            close(f"K ({name})", k.K, p.K, 1e-4, 1e-6),
            close(f"cov_upd ({name})", k.cov_upd, p.cov_upd, 1e-4, 1e-6),
            close(f"z_exp ({name})", k.z_exp, p.z_exp, 1e-5, 1e-6),
            close(f"cand_w ({name})", k.cand_w, p.cand_w, 1e-5, 1e-8)]
    np.testing.assert_array_equal(k.unused.cpu().numpy(),
                                  p.unused.cpu().numpy(),
                                  err_msg=f"unused ({name})")
    nz = (p.cand_w > 0).cpu().numpy()
    np.testing.assert_array_equal(k.cand_m.cpu().numpy()[nz],
                                  p.cand_m.cpu().numpy()[nz],
                                  err_msg=f"cand_m ({name})")
    return max(case), nz


def check_map_update(torch, mu, filt, state, z, z_mask):
    gm, cfg = state.gm, filt.cfg
    if not bool(gm.alive.any()):
        raise AssertionError("map_update2d: the mid-run map is empty")
    params = mu.pack_params(filt.meas, filt.gates,
                            cfg.new_gaussian_md_threshold,
                            cfg.birth_gaussian_weight)
    args = (state.particles.pose, gm.mean[0], gm.mean[1], gm.cov[0],
            gm.cov[1], gm.cov[2], gm.w, gm.w_prev, gm.alive, z, z_mask,
            params, cfg.new_per_z)
    errs = []
    for name, a in map_update_cases(torch, args):
        err, nz = compare_map_update(torch, name, mu.fused_map_update2d(*a),
                                     mu.map_update2d_plain(*a))
        errs.append(err)
        print(f"map_update2d: kernel == twin on {name} (M={a[1].shape[1]}, "
              f"Zc={a[9].shape[0]}, {int(a[8].sum())} alive slots, "
              f"{int(nz.sum())} candidates; max abs error {err:.3g})",
              flush=True)
    return (max(errs), *kernel_vs_twin_ms(
        torch, "map_update2d", lambda: mu.fused_map_update2d(*args),
        lambda: mu.map_update2d_plain(*args)),
        *map_update_bound(args, mu.fused_map_update2d(*args)))


def check_map_update_block(torch, mu, filt, state, z, z_mask):
    """Phase 3b: ``map_update2d``'s block form (head and tail launches per
    block, the column sums combined in block order, the picks merged) on
    the mid-run state split into MAP_BLOCKS blocks of slots, against the
    same form's twin (the kernel-against-twin tolerances, the unused flags
    and the positive picks equal) and against the one-launch kernel (the
    unused flags and the positive picks equal); then the device time of
    one block's two launches (one rank's share, P=200, M=64) beside its
    twin's and the bound of that work.  Returns ``(max abs error, ms,
    plain_ms, bound_ms, bound_by)``."""
    gm, cfg = state.gm, filt.cfg
    args = (state.particles.pose, gm.mean[0], gm.mean[1], gm.cov[0],
            gm.cov[1], gm.cov[2], gm.w, gm.w_prev, gm.alive, z, z_mask,
            filt._map_params, cfg.new_per_z)
    k = mu.map_update2d_blocks(*args, n_blocks=MAP_BLOCKS)
    p = mu.map_update2d_blocks(*args, n_blocks=MAP_BLOCKS, plain=True)
    one = mu.fused_map_update2d(*args)
    torch.cuda.synchronize()
    errs = [close("block pd", k.pd, p.pd, 1e-6, 1e-7),
            close("block col_sum", k.col_sum, p.col_sum, 5e-5, 1e-7),
            close("block w", k.w, p.w, 5e-5, 1e-7),
            close("block w_prev", k.w_prev, p.w_prev, 0, 0),
            close("block K", k.K, p.K, 1e-4, 1e-6),
            close("block cov_upd", k.cov_upd, p.cov_upd, 1e-4, 1e-6),
            close("block z_exp", k.z_exp, p.z_exp, 1e-5, 1e-6),
            close("block cand_w", k.cand_w, p.cand_w, 1e-5, 1e-8)]
    for name, want in (("twin", p), ("one launch", one)):
        np.testing.assert_array_equal(k.unused.cpu().numpy(),
                                      want.unused.cpu().numpy(),
                                      err_msg=f"block unused ({name})")
        nz = (want.cand_w > 0).cpu().numpy()
        np.testing.assert_array_equal(k.cand_m.cpu().numpy()[nz],
                                      want.cand_m.cpu().numpy()[nz],
                                      err_msg=f"block cand_m ({name})")
    M = gm.w.shape[1]
    Mb = M // MAP_BLOCKS
    blk = tuple(x[:, :Mb].contiguous() for x in args[1:9])
    head = mu.map_update2d_head(args[0], *blk, z, z_mask, args[11])
    col_sum = mu.combine_col_sums(head.col_part[None], args[11][4])

    def launches():
        mu.map_update2d_head(args[0], *blk, z, z_mask, args[11])
        mu.map_update2d_tail(args[0], *blk[:6], blk[7], z, z_mask, args[11],
                             col_sum, cfg.new_per_z, 0)

    def twins():
        mu.map_update2d_head_plain(args[0], *blk, z, z_mask, args[11])
        mu.map_update2d_tail_plain(args[0], *blk[:6], blk[7], z, z_mask,
                                   args[11], col_sum, cfg.new_per_z, 0)

    ms, plain_ms = kernel_vs_twin_ms(torch, "map_update2d block", launches,
                                     twins)
    # the bound of one block's map update: its inputs read once, the
    # head's and the tail's outputs written once, the operations its
    # cells need
    tail = mu.map_update2d_tail(args[0], *blk[:6], blk[7], z, z_mask,
                                args[11], col_sum, cfg.new_per_z, 0)
    bound_ms, bound_by = map_update_bound(
        (args[0], *blk, z, z_mask, args[11], cfg.new_per_z),
        mu.FusedMapUpdate(
            w=tail.w, w_prev=head.w_prev, pd=head.pd, col_sum=head.col_part,
            unused=tail.unused, cand_w=tail.cand_w, cand_m=tail.cand_m,
            K=head.K, cov_upd=head.cov_upd, z_exp=head.z_exp))
    rec = {"map_update2d_block": f"{MAP_BLOCKS} blocks of {Mb} slots",
           "particles": int(gm.w.shape[0]), "max_abs_err": max(errs),
           "block_ms": ms, "block_plain_ms": plain_ms,
           "block_bound_ms": bound_ms, "block_bound_by": bound_by,
           "picks": int((k.cand_w > 0).sum())}
    print(json.dumps(rec), flush=True)
    return max(errs), ms, plain_ms, bound_ms, bound_by


def random_mixtures(torch, GMState, rng, P, N, dev, n_alive=(20, 120),
                    spread=3.0):
    """Random D=2 mixtures, ``n_alive`` alive slots per particle (20-120),
    alive first, their means in a square of half-width ``spread``."""
    mean = rng.uniform(-spread, spread, size=(P, N, 2)).astype(np.float32)
    A = rng.normal(size=(P, N, 2, 2)).astype(np.float32) * 0.2
    cov = A @ np.swapaxes(A, -1, -2) + 0.3 * np.eye(2, dtype=np.float32)
    w = rng.uniform(0.1, 1.0, size=(P, N)).astype(np.float32)
    alive = np.arange(N)[None, :] < rng.integers(n_alive[0], n_alive[1] + 1,
                                                 size=(P, 1))
    t = lambda a: torch.as_tensor(a, device=dev)
    return GMState(
        mean=t(np.moveaxis(mean, -1, 0).copy()),
        cov=t(np.stack([cov[..., 0, 0], cov[..., 0, 1], cov[..., 1, 1]])),
        w=t(w), w_prev=t(w * 0.5), alive=t(alive))


def edge_mixtures(torch, GMState, rng, dev):
    """The mixtures the kernel's gate bit mask hinges on
    (tests/test_torch_gm.py's, at P=200): gated chains across 32-slot
    words, every slot alive, N=100, a particle with no alive slot."""
    P, N = 200, 128
    mean = rng.uniform(-40, 40, size=(2, P, N)).astype(np.float32)
    for s0 in (30, 62):
        mean[0, :, s0:s0 + 5] = 0.25 * np.arange(5) + s0
        mean[1, :, s0:s0 + 5] = 0.0
    cov = np.zeros((3, P, N), np.float32)
    cov[0] = cov[2] = 0.04
    w = np.tile(np.linspace(1.0, 0.2, N, dtype=np.float32), (P, 1))
    t = lambda a: torch.as_tensor(a, device=dev)
    chains = GMState(mean=t(mean), cov=t(cov), w=t(w), w_prev=t(w * 0.5),
                     alive=t(np.arange(N)[None, :] < 100).expand(P, N)
                     .contiguous())
    full = random_mixtures(torch, GMState, rng, P, N, dev)
    full = GMState(full.mean, full.cov, full.w, full.w_prev,
                   torch.ones_like(full.alive))
    empty = random_mixtures(torch, GMState, rng, P, N, dev)
    empty.alive[1] = False
    return [("word boundary", chains), ("all alive", full),
            ("N=100", random_mixtures(torch, GMState, rng, P, 100, dev)),
            ("empty particle", empty)]


def check_merge(torch, mg, gm_ops, GMState, filt, state, z, z_mask, dev):
    cfg = filt.cfg
    gm_full = filt._map_update(state, z, z_mask)[0]
    cases = [("mid-run", gm_ops.compact(gm_full, gm_full.capacity),
              cfg.merge_threshold, cfg.merge_inflation)]
    rng = np.random.default_rng(0)
    for _ in range(2):
        cases.append(("random", random_mixtures(torch, GMState, rng, 200, 128,
                                                dev), 1.5, 1.5))
    cases += [(name, gm, 1.5, 1.5)
              for name, gm in edge_mixtures(torch, GMState, rng, dev)]
    errs = [compare_merge2d(torch, mg, name, gm, thr, infl)[1]
            for name, gm, thr, infl in cases]
    gm, thr, infl = cases[0][1:]
    return (max(errs), *kernel_vs_twin_ms(
        torch, "merge2d", lambda: mg.merge2d(gm, thr, infl),
        lambda: mg.merge2d_plain(gm, thr, infl)),
        *merge_bound(gm_ops, gm, mg.merge2d(gm, thr, infl), thr, infl,
                     inv_flop=7, merge_flop=30))


def compare_merge2d(torch, mg, name, gm, thr, infl):
    """merge2d against its twin on one input: alive exact, floats within
    tests/test_pallas_merge.py's tolerances; returns the twin's output and
    the maximum absolute error."""
    k = mg.merge2d(gm, thr, infl)
    p = mg.merge2d_plain(gm, thr, infl)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(k.alive.cpu().numpy(),
                                  p.alive.cpu().numpy(),
                                  err_msg=f"merge2d alive ({name})")
    a = p.alive.cpu().numpy()
    err = max(close(f"w ({name})", k.w, p.w, 1e-5, 0, a),
              close(f"mean ({name})", k.mean, p.mean, 1e-4, 1e-5, a),
              close(f"cov ({name})", k.cov, p.cov, 1e-3, 1e-5, a),
              close(f"w_prev ({name})", k.w_prev, p.w_prev, 1e-5, 0, a))
    print(f"merge2d: kernel == twin on {name} mixtures "
          f"(N={gm.capacity}, {int(gm.count().sum())} -> "
          f"{int(p.count().sum())} alive; max abs error {err:.3g})",
          flush=True)
    return p, err


def random_mixtures3(torch, GMState, rng, P, N, dev, n_alive=(40, 400),
                     spread=3.0):
    """Random D=3 mixtures (tests/test_pallas_merge3d.py's: diameters
    0.2-1.0), ``n_alive`` (at most N) alive slots per particle, alive
    first, x and y in a square of half-width ``spread``."""
    mean = rng.uniform(-spread, spread, size=(P, N, 3)).astype(np.float32)
    mean[..., 2] = rng.uniform(0.2, 1.0, size=(P, N))
    A = rng.normal(size=(P, N, 3, 3)).astype(np.float32) * 0.2
    cov = A @ np.swapaxes(A, -1, -2) + 0.3 * np.eye(3, dtype=np.float32)
    w = rng.uniform(0.1, 1.0, size=(P, N)).astype(np.float32)
    alive = np.arange(N)[None, :] < rng.integers(
        n_alive[0], min(n_alive[1], N) + 1, size=(P, 1))
    t = lambda a: torch.as_tensor(a, device=dev)
    return GMState(
        mean=t(np.moveaxis(mean, -1, 0).copy()),
        cov=t(np.stack([cov[..., i, j] for i in range(3)
                        for j in range(i, 3)])),
        w=t(w), w_prev=t(w * 0.5), alive=t(alive))


def edge_mixtures3(torch, GMState, rng, P, N, dev):
    """The D=3 mixtures the kernel's gate bit mask hinges on, at the
    path's width: gated chains across 32-slot words (500 alive, so the
    alive bound is no multiple of 32), every slot alive, N=100, N=1024, a
    particle with no alive slot, and a gated pair of zero weight in every
    particle (slots 0 and 1), which keeps both slots."""
    mean = rng.uniform(-100, 100, size=(3, P, N)).astype(np.float32)
    mean[2] = 0.5
    for s0 in (30, 62, 254, 478):
        mean[0, :, s0:s0 + 5] = 0.25 * np.arange(5) + s0
        mean[1, :, s0:s0 + 5] = 0.0
    cov = np.zeros((6, P, N), np.float32)
    cov[0] = cov[3] = cov[5] = 0.04
    w = np.tile(np.linspace(1.0, 0.2, N, dtype=np.float32), (P, 1))
    t = lambda a: torch.as_tensor(a, device=dev)
    chains = GMState(mean=t(mean), cov=t(cov), w=t(w), w_prev=t(w * 0.5),
                     alive=t(np.arange(N)[None, :] < 500).expand(P, N)
                     .contiguous())
    full = random_mixtures3(torch, GMState, rng, P, N, dev, (N, N))
    empty = random_mixtures3(torch, GMState, rng, P, N, dev)
    empty.alive[1] = False
    zero = random_mixtures3(torch, GMState, rng, P, N, dev)
    zero.mean[:, :, 1] = zero.mean[:, :, 0] + 1e-3
    zero.w[:, :2] = 0.0
    return [("word boundary", chains), ("all alive", full),
            ("N=100", random_mixtures3(torch, GMState, rng, P, 100, dev,
                                       (40, 100))),
            ("N=1024", random_mixtures3(torch, GMState, rng, P, 1024, dev,
                                        (400, 1024))),
            ("empty particle", empty), ("zero-weight pair", zero)]


def compare_merge3d(torch, m3, name, gm, thr, infl):
    """merge3d against its twin on one input: alive exact, floats within
    tests/test_pallas_merge3d.py's tolerances; returns the twin's output
    and the maximum absolute error."""
    k = m3.merge3d(gm, thr, infl)
    p = m3.merge3d_plain(gm, thr, infl)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(k.alive.cpu().numpy(),
                                  p.alive.cpu().numpy(),
                                  err_msg=f"merge3d alive ({name})")
    a = p.alive.cpu().numpy()
    err = max(close(f"w ({name})", k.w, p.w, 1e-5, 0, a),
              close(f"mean ({name})", k.mean, p.mean, 1e-4, 1e-5, a),
              close(f"cov ({name})", k.cov, p.cov, 1e-3, 1e-4, a),
              close(f"w_prev ({name})", k.w_prev, p.w_prev, 1e-5, 0, a))
    print(f"merge3d: kernel == twin on {name} mixtures "
          f"(N={gm.capacity}, {int(gm.count().sum())} -> "
          f"{int(p.count().sum())} alive; max abs error {err:.3g})",
          flush=True)
    return p, err


def merge3d_cases(torch, GMState, filt, frame200_gm, dev):
    """merge3d's checked inputs: the Victoria Park merge input after 200
    frames, random mixtures at threshold 1.5 (several passes) and the edge
    mixtures, at the path's P=100 and N=512."""
    cfg = filt.cfg
    P, N = cfg.n_particles, cfg.map_capacity
    cases = [("frame-200", frame200_gm, cfg.merge_threshold,
              cfg.merge_inflation)]
    rng = np.random.default_rng(1)
    for _ in range(2):
        cases.append(("random", random_mixtures3(torch, GMState, rng, P, N,
                                                 dev), 1.5, 1.5))
    return cases + [(name, gm, 1.5, 1.5) for name, gm in
                    edge_mixtures3(torch, GMState, rng, P, N, dev)]


def check_merge3d(torch, m3, GMState, filt, frame200_gm, dev):
    """merge3d against its twin on every checked input; returns the
    largest absolute error."""
    errs = []
    for name, gm, thr, infl in merge3d_cases(torch, GMState, filt,
                                             frame200_gm, dev):
        p, err = compare_merge3d(torch, m3, name, gm, thr, infl)
        errs.append(err)
        if name == "zero-weight pair" and not bool(p.alive[:, :2].all()):
            raise AssertionError("merge3d: a zero-weight pair lost a slot")
    return max(errs)


def vp_merge_input(torch, gm_ops, filt, state, stream, j, dev):
    """The merge input of frame ``j``: the map update of its measurements
    on ``state``, compacted as gm.merge compacts it."""
    gm = filt._map_update(
        state, torch.as_tensor(stream.z[j], dtype=torch.float32, device=dev),
        torch.as_tensor(stream.z_mask[j], device=dev))[0]
    return gm_ops.compact(gm, gm.capacity)


def time_merge3d(torch, m3, gm_ops, filt, gm, err):
    """merge3d and its twin timed on the mid-stream merge input (checked
    first), with the state's alive slots, passes and merged pairs."""
    thr, infl = filt.cfg.merge_threshold, filt.cfg.merge_inflation
    _, case_err = compare_merge3d(torch, m3, "mid-stream", gm, thr, infl)
    trace = merge_trace(gm_ops, gm, thr, infl)
    alive = gm.alive.sum(dim=1).cpu().numpy()
    print(json.dumps({
        "merge3d_state": f"frame {VP_FRAMES} merge input",
        "alive_per_particle": {"min": int(alive.min()),
                               "median": float(np.median(alive)),
                               "max": int(alive.max())},
        "passes_max": len(trace),
        "passes_total": int(sum(float(a.sum()) for a, *_ in trace)),
        "pairs_merged": int(sum(float(m.sum()) for _, _, m, _ in trace))}),
        flush=True)
    return (max(err, case_err), *kernel_vs_twin_ms(
        torch, "merge3d", lambda: m3.merge3d(gm, thr, infl),
        lambda: m3.merge3d_plain(gm, thr, infl)),
        *merge_bound(gm_ops, gm, m3.merge3d(gm, thr, infl), thr, infl,
                     inv_flop=25, merge_flop=60))


def vp_streams():
    """The synthetic Victoria Park streams (seed 0: 7,230 frames without
    scans, and 200 frames with scans) and their config, written under
    build/ once."""
    from rfs_slam_tpu_torch.io import vp_synth

    plain = os.path.join(VP_DIR, "seed0")
    scans = os.path.join(VP_DIR, "seed0_scans")
    if not os.path.exists(os.path.join(plain, "gps.dat")):
        vp_synth.write(plain, seed=0)
    if not os.path.exists(os.path.join(scans, "LASER.txt")):
        vp_synth.write(scans, seed=0, n_frames=VP_SCAN_FRAMES, scans=True)
    return plain, scans, vp_synth.write_config(os.path.join(VP_DIR,
                                                            "config.xml"))


def vp_finite(torch, state, outs):
    alive = state.gm.alive
    return (np.isfinite(outs["pose"]).all() and np.isfinite(outs["w"]).all()
            and bool(torch.isfinite(state.particles.log_w).all())
            and bool(torch.isfinite(state.gm.w[alive]).all())
            and bool(torch.isfinite(state.gm.mean[:, alive]).all())
            and bool(torch.isfinite(state.gm.cov[:, alive]).all()))


def timed_run(torch, loop, filt, inputs, seed, dt, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, best = loop.run(filt, inputs, gen, dt)
    torch.cuda.synchronize()
    return state, best, time.perf_counter() - t0


def fastslam_setup(kind, steps, dev):
    """The FastSLAM filter of ``kind`` (the stand-in config of
    ``io/sim2d_xml.py``) on ``dev``, with ``sim2d.generate(traj_seed=1,
    noise_seed=1)`` and its first ``steps`` steps' inputs: ``(filter,
    sim config, data, inputs)``."""
    from rfs_slam_tpu_torch.apps import fastslam2dsim as fs_app
    from rfs_slam_tpu_torch.apps import sim2d_common as loop
    from rfs_slam_tpu_torch.io import sim2d, sim2d_xml
    from rfs_slam_tpu_torch.io.xmlconfig import XmlConfig, load_sim2d

    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    # a directory of its own: the seed workers run this beside each other
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as d:
        cfg = XmlConfig(sim2d_xml.write_config(
            os.path.join(d, f"{kind}2dSim.xml"), kind))
    sim_cfg = load_sim2d(cfg)
    data = sim2d.generate(sim_cfg, traj_seed=1, noise_seed=1)
    zc = max(data.z.shape[1], 4)
    filt = fs_app.build_filter_from_xml(cfg, sim_cfg, z_capacity=zc,
                                        device=dev)
    return filt, sim_cfg, data, loop.sim_inputs(data, steps=steps,
                                                z_capacity=zc)


def seed_worker(kind, steps, seeds, device):
    """A worker process's share of the divergence bound's seeds: the run of
    :func:`fastslam_setup` for each generator seed, its median position
    error over steps >= 150."""
    import torch
    from rfs_slam_tpu_torch.apps import sim2d_common as loop

    dev = torch.device(device)
    filt, sim_cfg, data, inputs = fastslam_setup(kind, steps, dev)
    n = len(inputs[0])
    return loop.seed_errors(filt, inputs, data.gt_pose[1:n + 1], sim_cfg.dt,
                            seeds, dev)


def keep_mid_tables(filt, din, k, state, mid):
    """A step loop's record: after step ``k`` = FS_MID_STEP - 1, keep in
    ``mid["tables"]`` the DA tables of the next update."""
    if k == FS_MID_STEP - 1 and k + 1 < len(din[-1]):
        mid["tables"] = filt._da_table(state.particles.pose, state.gm,
                                       din[1][k + 1], din[2][k + 1],
                                       filt.meas)[0]


def hungarian_per_update(filt):
    """``hungarian`` launches of one FastSLAM update with measurements: one
    (FastSLAM 1.0), or the gated root, Murty's root and its H - 1 waves
    (MH with a lane budget below the particle axis; H without the gate)."""
    c = filt.cfg
    if c.max_hypotheses == 1:
        return 1
    gated = (c.murty_lane_budget is not None
             and c.murty_lane_budget < filt.p_cap)
    return c.max_hypotheses + 1 if gated else c.max_hypotheses


def fastslam_run(torch, loop, hk, kind, steps, dev, logged=False):
    """One FastSLAM run of :func:`fastslam_setup`, the step loop under
    torch's sync debug mode (a read-back inside it raises); the
    divergence bound's other seeds run later (:func:`submit_sim_seeds`).
    ``logged``: also keep what the reference's logs hold
    (``sim2d_common.log_recorder``).  Returns ``(filter, final state,
    device inputs, generator, the DA tables of FS_MID_STEP (or None), a
    record, the logs as numpy arrays (or None), dt)``."""
    filt, sim_cfg, data, inputs = fastslam_setup(kind, steps, dev)
    din = loop.device_inputs(inputs, dev)
    n = len(din[-1])
    best = torch.empty((n, 3), device=dev)
    mid = {}
    logs, log_record = (loop.log_recorder(filt, n, dev) if logged
                        else (None, None))

    def record(k, state):
        b = torch.argmax(state.particles.log_w).view(1)
        best[k] = state.particles.pose.index_select(0, b)[0]
        keep_mid_tables(filt, din, k, state, mid)
        if log_record is not None:
            log_record(k, state)

    gen = torch.Generator(device=dev).manual_seed(0)
    hk.launches = 0
    held = reset_peak(torch, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = loop.steps(filt, din, gen, sim_cfg.dt, record)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = hk.launches
    path_check(torch, f"{kind} sim2d", state.gm, True, held, dev)
    c = filt.cfg
    n_upd = int(din[-1].sum())
    if launches != hungarian_per_update(filt) * n_upd:
        raise AssertionError(f"hungarian: {launches} launches on the {kind} "
                             f"path, {n_upd} updates had measurements")
    best = best.cpu().numpy()
    gt = data.gt_pose[1:n + 1]
    err = loop.median_pose_error(best, gt)
    dr = loop.median_pose_error(data.dr_pose[1:n + 1], gt)
    alive = state.gm.alive
    live = torch.isfinite(state.particles.log_w)
    finite = (np.isfinite(best).all()
              and bool(torch.isfinite(state.particles.pose[live]).all())
              and bool(torch.isfinite(state.gm.w[alive]).all())
              and bool(torch.isfinite(state.gm.mean[:, alive]).all()))
    rec = {"path": f"{kind} sim2d traj_seed=1 noise_seed=1",
           "steps": n, "steps_cut_from": data.gt_pose.shape[0] - 1,
           "particles": c.n_particles, "particle_axis": filt.p_cap,
           "hypotheses": c.max_hypotheses, "nmz": c.nmz_capacity,
           "map_capacity": c.map_capacity, "wall_s": wall,
           "steps_per_s": n / wall, "logged": logged,
           "median_pose_err_m": err,
           "dead_reckoning_m": dr, "hungarian_launches": launches,
           "updates_with_measurements": n_upd, "finite": bool(finite),
           "live_particles": int(live.sum()),
           "best_alive": int(alive[int(torch.argmax(
               state.particles.log_w))].sum())}
    if not finite:
        raise AssertionError(f"{kind}: non-finite outputs")
    if logs is not None:
        logs = {k: v.cpu().numpy() for k, v in logs.items()}
    return filt, state, din, gen, mid.get("tables"), rec, logs, sim_cfg.dt


def vp_fastslam_setup(plain, cfg_path, hypotheses, n_frames, dev):
    """The Victoria Park FastSLAM filter (``hypotheses``) at the app's
    width on ``dev``, the synthetic stream and its first ``n_frames``
    frames: ``(filter, input_cov, stream, frames)``."""
    from rfs_slam_tpu_torch.apps import fastslam_victoriapark as fs_vp
    from rfs_slam_tpu_torch.apps import rbphdslam_victoriapark as vp_app
    from rfs_slam_tpu_torch.io import victoria_park as vp_io
    from rfs_slam_tpu_torch.io.xmlconfig import XmlConfig

    filt, icov, ack = fs_vp.build(XmlConfig(cfg_path), hypotheses=hypotheses,
                                  device=dev)
    stream = vp_io.load(plain, z_capacity=fs_vp.Z_CAPACITY, ackerman=ack)
    return filt, icov, stream, vp_app.head(stream, n_frames)


def vp_seed_worker(plain, cfg_path, hypotheses, n_frames, seeds, device):
    """A worker process's share of a VP divergence bound's seeds: the RMSE
    against the GPS of one run of :func:`vp_fastslam_setup` per generator
    seed."""
    import torch
    from rfs_slam_tpu_torch.apps import fastslam_victoriapark as fs_vp
    from rfs_slam_tpu_torch.apps import rbphdslam_victoriapark as vp_app

    dev = torch.device(device)
    filt, icov, _, frames = vp_fastslam_setup(plain, cfg_path, hypotheses,
                                              n_frames, dev)
    out = []
    for seed in seeds:
        _, outs = fs_vp.run(filt, icov, frames, torch.Generator(
            device=dev).manual_seed(seed), progress=False)
        out.append(vp_app.trajectory_rmse(frames, outs)[0])
    return out


def vp_fastslam_run(torch, hk, plain, cfg_path, hypotheses, n_frames, seeds,
                    dev):
    """Phases 11-12: one Victoria Park FastSLAM run through the app's
    ``run`` (chunks of VP_FS_CHUNK frames, each under torch's sync debug
    mode set to raise), its ``hungarian`` launches held to the frames with
    measurements.  The bound's other ``seeds`` run later in worker
    processes (:func:`submit_vp_seeds`).  Returns ``(filter, final state,
    stream, record)``."""
    from rfs_slam_tpu_torch.apps import fastslam_victoriapark as fs_vp
    from rfs_slam_tpu_torch.apps import rbphdslam_victoriapark as vp_app

    filt, icov, stream, frames = vp_fastslam_setup(plain, cfg_path,
                                                   hypotheses, n_frames, dev)
    n_meas = int(frames.z_mask.any(axis=1).sum())
    gen = torch.Generator(device=dev).manual_seed(0)
    hk.launches = 0
    held = reset_peak(torch, dev)
    t0 = time.perf_counter()
    state, outs = fs_vp.run(filt, icov, frames, gen, ckpt_every=VP_FS_CHUNK,
                            check_reads=True, progress=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = hk.launches
    path_check(torch, f"victoria_park fastslam H={hypotheses}", state.gm,
               True, held, dev)
    if launches != hungarian_per_update(filt) * n_meas:
        raise AssertionError(f"hungarian: {launches} launches on the VP "
                             f"FastSLAM path (H={hypotheses}), {n_meas} "
                             f"frames had measurements")
    live = torch.isfinite(state.particles.log_w)
    alive = state.gm.alive
    if not (np.isfinite(outs["pose"]).all() and np.isfinite(outs["w"]).all()
            and bool(torch.isfinite(state.particles.pose[live]).all())
            and bool(torch.isfinite(state.gm.w[alive]).all())
            and bool(torch.isfinite(state.gm.mean[:, alive]).all())):
        raise AssertionError(f"VP FastSLAM H={hypotheses}: non-finite "
                             f"outputs")
    rmse, dr = vp_app.trajectory_rmse(frames, outs)
    c = filt.cfg
    rec = {"path": f"victoria_park fastslam H={hypotheses} synthetic stream "
                   f"seed 0", "frames": len(frames.t),
           "frames_cut_from": len(stream.t), "particles": c.n_particles,
           "particle_axis": filt.p_cap, "hypotheses": c.max_hypotheses,
           "map_capacity": c.map_capacity, "nmz": c.nmz_capacity,
           "chunk_frames": VP_FS_CHUNK, "wall_s": wall,
           "frames_per_s": len(frames.t) / wall, "rmse_m": rmse,
           "dead_reckoning_rmse_m": dr, "hungarian_launches": launches,
           "frames_with_measurements": n_meas,
           "live_particles": int(live.sum()),
           "best_alive": int(alive[int(torch.argmax(
               state.particles.log_w))].sum())}
    rec["seeds"] = [0, *seeds]
    return filt, state, stream, rec


def submit_sim_seeds(pool, runs, dev):
    """The 2-D FastSLAM bounds' other seeds, one task a seed on ``pool``:
    ``runs`` holds ``(record, kind, steps)``; returns ``(record,
    futures)`` pairs for :func:`collect_sim_seeds`."""
    out = []
    for rec, kind, steps in runs:
        seeds = FS_BOUND_SEEDS if kind == "fastslam" else MH_BOUND_SEEDS
        rec["seeds"] = [0, *seeds]
        out.append((rec, [pool.submit(seed_worker, kind, steps, (s,),
                                      str(dev)) for s in seeds]))
    return out


def collect_sim_seeds(submitted):
    """Each record's seed errors (the main run's first) and their median,
    printed with the record."""
    for rec, futures in submitted:
        rec["seed_errors_m"] = [rec["median_pose_err_m"]] + [
            f.result()[0] for f in futures]
        rec["median_of_seeds_m"] = float(np.median(rec["seed_errors_m"]))
        print(json.dumps(rec), flush=True)


def submit_vp_seeds(pool, plain, cfg_path, runs, dev):
    """The VP bounds' other seeds, one task a seed on ``pool``: ``runs``
    holds ``(record, hypotheses, frames)``; returns ``(record, futures)``
    pairs for :func:`collect_vp_seeds`."""
    return [(rec, [pool.submit(vp_seed_worker, plain, cfg_path, h, n, (s,),
                               str(dev)) for s in rec["seeds"][1:]])
            for rec, h, n in runs]


def collect_vp_seeds(submitted):
    """Each record's seed RMSEs (the main run's first) and their median,
    printed with the record."""
    for rec, futures in submitted:
        rec["seed_rmse_m"] = [rec["rmse_m"]] + [f.result()[0]
                                                for f in futures]
        rec["median_of_seeds_m"] = float(np.median(rec["seed_rmse_m"]))
        print(json.dumps(rec), flush=True)


def seed_pool():
    return concurrent.futures.ProcessPoolExecutor(
        SEED_WORKERS, mp_context=multiprocessing.get_context("spawn"))


def bit_view(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def state_arrays(state, where="state"):
    """A state dataclass's tensors as numpy arrays by dotted name."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if dataclasses.is_dataclass(v):
            out.update(state_arrays(v, f"{where}.{f.name}"))
        else:
            out[f"{where}.{f.name}"] = v.cpu().numpy()
    return out


def vp_resume(torch, plain, cfg_path, dev):
    """Phase 13: for both Victoria Park apps at their widths, an unbroken
    VP_RESUME_FRAMES-frame run against one cut after its first chunk of
    half as many frames and resumed from a temporary directory: outputs
    and final state equal bit for bit (floats as int32 views)."""
    from rfs_slam_tpu_torch.apps import fastslam_victoriapark as fs_vp
    from rfs_slam_tpu_torch.apps import rbphdslam_victoriapark as vp_app
    from rfs_slam_tpu_torch.io import victoria_park as vp_io
    from rfs_slam_tpu_torch.io.xmlconfig import XmlConfig
    from rfs_slam_tpu_torch.utils import checkpoint

    half = VP_RESUME_FRAMES // 2
    for kind, mod in (("rbphd", vp_app), ("fastslam", fs_vp)):
        filt, icov, ack = mod.build(XmlConfig(cfg_path), device=dev)
        frames = vp_app.head(vp_io.load(plain, z_capacity=mod.Z_CAPACITY,
                                        ackerman=ack), VP_RESUME_FRAMES)

        def gen():
            return torch.Generator(device=dev).manual_seed(0)

        t0 = time.perf_counter()
        want_state, want = mod.run(filt, icov, frames, gen(), progress=False)
        with tempfile.TemporaryDirectory(
                dir=os.path.join(HERE, "build")) as d:
            mod.run(filt, icov, vp_app.head(frames, half), gen(), ckpt_dir=d,
                    ckpt_every=half, progress=False)
            cut = checkpoint.latest_step(d)
            state, got = mod.run(filt, icov, frames, gen(), ckpt_dir=d,
                                 ckpt_every=half, resume=True,
                                 progress=False)
        torch.cuda.synchronize()
        for name in want:
            np.testing.assert_array_equal(
                bit_view(got[name]), bit_view(want[name]),
                err_msg=f"resume {kind}: output {name}")
        a, b = state_arrays(state), state_arrays(want_state)
        for name in b:
            np.testing.assert_array_equal(
                bit_view(a[name]), bit_view(b[name]),
                err_msg=f"resume {kind}: {name}")
        print(json.dumps({
            "resume": f"victoria_park {kind}", "frames": len(frames.t),
            "particles": filt.cfg.n_particles,
            "map_capacity": filt.cfg.map_capacity, "cut_after_frame": half,
            "resumed_from_frame": cut, "outputs_bit_equal": True,
            "state_bit_equal": True, "arrays_compared": len(want) + len(b),
            "wall_s": time.perf_counter() - t0}), flush=True)


def vp_fastslam_phases(torch, hk, plain, cfg_path, dev):
    """The main runs of phases 11-12, each with its bound; returns
    ``(runs, tables, fs)``: ``(record, hypotheses, frames)`` for
    :func:`submit_vp_seeds`, the DA tables of frame VP_FS_TABLE_FRAME
    on FastSLAM 1.0's final state (a ``hungarian`` case of phase 9), and
    that run's ``(filter, final state, stream)`` (phase 14)."""
    filt, state, stream, rec = vp_fastslam_run(
        torch, hk, plain, cfg_path, 1, VP_FS_FRAMES, VP_FS_BOUND_SEEDS, dev)
    rec["divergence_bound_m"] = VP_FS_DIVERGENCE_BOUND_M
    runs = [(rec, 1, VP_FS_FRAMES)]
    j = VP_FS_TABLE_FRAME
    tables = filt._da_table(
        state.particles.pose, state.gm,
        torch.as_tensor(stream.z[j], dtype=torch.float32, device=dev),
        torch.as_tensor(stream.z_mask[j], device=dev), filt.meas)[0]
    *_, rec = vp_fastslam_run(torch, hk, plain, cfg_path, 3, VP_MH_FRAMES,
                              VP_MH_BOUND_SEEDS, dev)
    rec["divergence_bound_m"] = VP_MH_DIVERGENCE_BOUND_M
    runs.append((rec, 3, VP_MH_FRAMES))
    return runs, tables, (filt, state, stream)


def check_vp_accuracy(runs):
    """Phases 11-12's accuracy: the median RMSE of the seeds within the
    divergence bound and below dead reckoning's."""
    for rec, _, _ in runs:
        med = rec["median_of_seeds_m"]
        if not med < rec["dead_reckoning_rmse_m"]:
            raise AssertionError(f"{rec['path']}: median RMSE over seeds "
                                 f"{med} m is not below dead reckoning's")
        if not med <= rec["divergence_bound_m"]:
            raise AssertionError(f"{rec['path']}: median RMSE over seeds "
                                 f"{rec['seeds']} {med} m > "
                                 f"{rec['divergence_bound_m']} m")


def recorded_update(torch, hk, filt, state, din, gen):
    """The inputs of every ``hungarian`` call of one more update (the MH
    path: the gated root, Murty's root and its waves)."""
    k = int(np.flatnonzero(din[-1])[-1])
    seen = []
    launch = hk.hungarian_uv

    def spy(cost):
        seen.append(cost.clone())
        return launch(cost)

    hk.hungarian_uv = spy
    try:
        filt.update(state, din[1][k], din[2][k], gen=gen, has_z=True)
    finally:
        hk.hungarian_uv = launch
    return seen


def hungarian_cases(torch, A, fs_tables, mh_inputs, vp_tables, dev):
    """The inputs ``hungarian`` is held to its twin on."""
    rng = np.random.default_rng(2)

    def rand(B, n):
        return torch.as_tensor((rng.normal(size=(B, n, n)) * 3).astype(
            np.float32), device=dev)

    neg = rand(64, 32)
    neg[:, 5, :] = A.NEG
    neg[:, :, 7] = A.NEG
    # each row's maximum a 0.0 or -0.0 at several columns, tied under <
    zeros = -rand(64, 32).abs() - 0.5
    hit = torch.as_tensor(rng.random((64, 32, 32)) < 0.2, device=dev)
    sign = torch.as_tensor(rng.random((64, 32, 32)) < 0.5, device=dev)
    zeros[hit] = torch.where(sign, 0.0, -0.0)[hit]
    # rows and columns below -INF: column 0 wins the argmin with delta INF
    beyond = rand(4, 33)
    beyond[0, 1, :] = -3e38
    beyond[1] = -3e38
    beyond[2, :, 0] = -3e38
    beyond[3, 0, :2] = -3e38
    names = ("MH gated root", "MH Murty root", "MH wave 1 (NEG bans)",
             "MH wave 2 (NEG bans)")
    return ([(f"random B={B}", rand(B, 32)) for B in (200, 600, 1200)]
            + [(f"FastSLAM DA tables, step {FS_MID_STEP}", fs_tables),
               (f"VP FastSLAM DA tables, frame {VP_FS_TABLE_FRAME}",
                vp_tables)]
            + list(zip(names, mh_inputs))
            + [("all equal (ties)", torch.ones((64, 32, 32), device=dev)),
               ("NEG row and column", neg),
               ("-0.0 and +0.0 tied", zeros), ("B=1", rand(1, 32)),
               ("beyond -INF", beyond), ("n=1", rand(16, 1)),
               ("n=31", rand(64, 31)), ("n=33", rand(64, 33)),
               ("n=52 (batchsim NMZ)", rand(200, 52)),
               ("n=63", rand(64, 63)), ("n=64", rand(64, 64)),
               ("n=128", rand(16, 128)), ("n=200", rand(4, 200)),
               ("n=241 (global memory)", rand(4, 241)),
               ("n=300 (global memory)", rand(2, 300)),
               ("n=1024 (global memory)", rand(1, 1024))])


def check_hungarian(torch, hk, A, cases, timed):
    """Kernel against twin on every case: row_to_col equal, u / v / total
    equal to the bit (their max abs error printed); then timed on each of
    ``timed`` (``(name, tables)`` pairs, one JSON line each).  The kernel
    table's row is the first one's, with the bound from the twin's trips
    and used columns there."""
    errs = []
    for name, cost in cases:
        k = hk.hungarian_uv(cost)
        p = A.hungarian_uv_plain(cost)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(k[0].cpu().numpy(), p[0].cpu().numpy(),
                                      err_msg=f"row_to_col ({name})")
        for f, a, b in zip(("total", "u", "v"), k[1:], p[1:]):
            np.testing.assert_array_equal(   # to the bit: -0.0 is not 0.0
                a.view(torch.int32).cpu().numpy(),
                b.view(torch.int32).cpu().numpy(), err_msg=f"{f} ({name})")
        case = [close(f"{f} ({name})", a, b, 0, 0)
                for f, a, b in zip(("total", "u", "v"), k[1:], p[1:])]
        errs += case
        plan = hk.launch_plan(*cost.shape[:2])
        print(f"hungarian: kernel == twin on {name} (B={cost.shape[0]}, "
              f"n={cost.shape[1]}, K={plan.k}, matrix in "
              f"{'shared' if plan.in_smem else 'global'} memory; max abs "
              f"error total {case[0]:.3g}, u {case[1]:.3g}, v "
              f"{case[2]:.3g})", flush=True)
    rows = []
    for name, tables in timed:
        ms = cuda_ms(torch, lambda: hk.hungarian_uv(tables))
        plain_ms = cuda_ms(torch, lambda: A.hungarian_uv_plain(tables), n=5,
                           warmup=1)
        call_ms = cuda_ms(torch, lambda: hk.hungarian_uv(tables),
                          queued=False)
        B, n, _ = tables.shape
        *out, trips, used = A.hungarian_uv_plain(tables, return_trips=True)
        n_trips, n_used = int(trips.sum()), int(used.sum())
        print(json.dumps({"hungarian_timed_on": name, "B": B, "n": n,
                          "search_trips": n_trips,
                          "used_columns_over_trips": n_used,
                          "trips_per_matrix_max": int(trips.max()),
                          "device_ms": ms, "twin_ms": plain_ms,
                          "call_ms": call_ms,
                          "ns_per_trip": ms * 1e6 / int(trips.max())}),
              flush=True)
        out_bytes = nbytes(*out) - nbytes(out[0]) + B * n * 4  # int32 cols
        rows.append((max(errs), ms, plain_ms, *bound(
            nbytes(tables) + out_bytes,
            (n_trips * (n + 1) - n_used) * HUNGARIAN_FLOP_UNUSED
            + n_used * HUNGARIAN_FLOP_USED)))
    return rows[0]


def jcbb_problem(torch, filt, state, stream, j, dev):
    """Phase 14's problem: the best particle of ``state`` (its pose and
    map) against frame ``j``'s measurements through the Victoria Park
    model.  Returns a dict: ``innov [Z, M, 3]`` (bearing wrapped),
    ``S_diag [M, 3, 3]``, ``z_mask [Z]``, ``m_mask [M]`` (alive),
    ``pose [3]``, ``xy [M, 2]``, ``z [Z, 3]``."""
    from rfs_slam_tpu_torch.core import gaussian, planar

    b = torch.argmax(state.particles.log_w).view(1)
    pose = state.particles.pose.index_select(0, b)[0]
    mean = state.gm.mean.index_select(1, b)[:, 0]          # [3, M]
    pred = filt.meas.measure_p(pose, mean,
                               state.gm.cov.index_select(1, b)[:, 0])
    z = torch.as_tensor(stream.z[j], dtype=torch.float32, device=dev)
    innov = z[:, None, :] - torch.stack(pred.z, dim=-1)[None]
    innov = torch.cat([innov[..., :1], gaussian.wrap_angle(innov[..., 1:2]),
                       innov[..., 2:]], dim=-1)
    S_diag = torch.stack([torch.stack(row, dim=-1)
                          for row in planar.sym_rows(pred.S, 3)], dim=-2)
    return dict(innov=innov.contiguous(), S_diag=S_diag.contiguous(),
                z_mask=torch.as_tensor(stream.z_mask[j], device=dev),
                m_mask=state.gm.alive.index_select(0, b)[0], pose=pose,
                xy=mean[:2].T.contiguous(), z=z)


def check_jcbb(torch, jc, prob, dev):
    """Phase 14a: ``jcbb_block_diag`` at the full width on the card
    against CPU copies, on the cut against the dense ``jcbb``, timed, and
    its peak device memory above its inputs."""
    args = tuple(prob[k] for k in ("innov", "S_diag", "z_mask", "m_mask"))
    Z, M, D = prob["innov"].shape

    def call(*a):
        return jc.jcbb_block_diag(*(a or args), beam=JCBB_BEAM)

    held = reset_peak(torch, dev)
    torch.cuda.set_sync_debug_mode("error")    # no read-back inside
    try:
        assoc, n, md2 = call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - held
    c_assoc, c_n, c_md2 = call(*(a.cpu() for a in args))
    np.testing.assert_array_equal(assoc.cpu().numpy(), c_assoc.numpy(),
                                  err_msg="jcbb_block_diag: card vs CPU")
    if int(n) != int(c_n):
        raise AssertionError(f"jcbb_block_diag: n_paired {int(n)} on the "
                             f"card, {int(c_n)} on the CPU")
    close("jcbb_block_diag md2", md2, c_md2.to(dev), 1e-5, 0.0)
    if peak > JCBB_PEAK_LIMIT:
        raise AssertionError(f"jcbb_block_diag: peak {peak} bytes above its "
                             f"inputs > {JCBB_PEAK_LIMIT}")

    # the cut: the first measurements, the alive landmarks nearest the
    # vehicle, against the dense search on the equivalent dense S
    zc, mc = JCBB_CUT
    d = torch.linalg.vector_norm(prob["xy"] - prob["pose"][:2], dim=-1)
    near = torch.argsort(torch.where(prob["m_mask"], d, float("inf")),
                         stable=True)[:mc]
    innov_c = prob["innov"][:zc, near].contiguous()
    S_c = prob["S_diag"][near]
    S = torch.zeros((zc, mc, zc, mc, D, D), device=dev)
    iz = torch.arange(zc, device=dev)[:, None]
    im = torch.arange(mc, device=dev)[None, :]
    S[iz, im, iz, im] = S_c.expand(zc, mc, D, D)
    cut = (innov_c, S_c, prob["z_mask"][:zc], prob["m_mask"][near])
    dense = jc.jcbb(innov_c, S, *cut[2:], beam=JCBB_BEAM)
    block = call(*cut)
    np.testing.assert_array_equal(block[0].cpu().numpy(),
                                  dense[0].cpu().numpy(),
                                  err_msg="jcbb cut: block-diagonal vs dense")
    if int(block[1]) != int(dense[1]):
        raise AssertionError("jcbb cut: n_paired differs from the dense "
                             "search's")
    ms, call_ms = cuda_ms(torch, call), cuda_ms(torch, call, queued=False)
    print(json.dumps({
        "phase14": "jcbb_block_diag", "Z": Z, "M": M, "D": D,
        "beam": JCBB_BEAM, "z_valid": int(prob["z_mask"].sum()),
        "m_alive": int(prob["m_mask"].sum()), "n_paired": int(n),
        "md2": float(md2), "cpu_md2": float(c_md2),
        "assoc_equal_cpu": True, "device_ms": ms, "call_ms": call_ms,
        "peak_above_inputs_bytes": peak, "peak_limit_bytes": JCBB_PEAK_LIMIT,
        "dense_S_bytes_at_this_width": Z * M * Z * M * D * D * 4,
        "cut": {"Z": zc, "M": mc, "dense_S_bytes": S.numel() * 4,
                "n_paired": int(dense[1]), "assoc_equal_dense": True}}),
        flush=True)


def check_spatial(torch, sp, filt, prob, dev):
    """Phase 14b: the grid index over the map's alive landmarks in x-y, a
    box query around the vehicle and the nearest landmark of each
    measurement's inverse-projected point, against brute force on the
    card, with the ring count and bucket cap at which the index is exact
    (the true neighbour within the rings, no bucket beyond the cap)."""
    xy, alive, pose = prob["xy"], prob["m_mask"], prob["pose"]
    lo = xy[alive].amin(dim=0) - 1.0
    hi = xy[alive].amax(dim=0) + 1.0
    res = tuple(int(v) for v in torch.ceil((hi - lo) / SPATIAL_CELL_M)
                .tolist())
    origin = tuple(lo.tolist())

    def build_index():
        return sp.build(xy, alive, origin, SPATIAL_CELL_M, res)

    idx = build_index()
    blo, bhi = pose[:2] - SPATIAL_BOX_M, pose[:2] + SPATIAL_BOX_M
    got, valid = sp.query_box(idx, blo.tolist(), bhi.tolist(), xy.shape[0])
    want = torch.nonzero(alive & (xy >= blo).all(dim=-1)
                         & (xy <= bhi).all(dim=-1))[:, 0]
    if set(got[valid].tolist()) != set(want.tolist()):
        raise AssertionError("query_box differs from brute force")

    z = prob["z"][prob["z_mask"]]
    q = filt.meas.inverse_p(pose, tuple(z[:, d] for d in range(3)))[0][:2].T
    diff = xy[None] - q[:, None]
    d2 = torch.where(alive[None], (diff * diff).sum(dim=-1), float("inf"))
    two = torch.sort(d2, dim=-1).values[:, :2]
    bf_idx = torch.argmin(d2, dim=-1)
    unique = two[:, 0] < two[:, 1]
    n_rings = int(torch.ceil(two[:, 0].max().sqrt() / SPATIAL_CELL_M)) + 1
    cap = int((idx.starts[1:] - idx.starts[:-1]).max())

    def nearest():
        return sp.nearest(idx, q, n_rings=n_rings, bucket_cap=cap)

    ni, nd, found = nearest()
    if not bool(found.all()):
        raise AssertionError("nearest: a query found no candidate")
    close("nearest dist", nd, two[:, 0].sqrt(), 1e-6, 0.0)
    np.testing.assert_array_equal(ni[unique].cpu().numpy(),
                                  bf_idx[unique].cpu().numpy(),
                                  err_msg="nearest: index vs brute force")
    print(json.dumps({
        "phase14": "spatial", "points": int(alive.sum()), "res": res,
        "cell_m": SPATIAL_CELL_M, "box_half_m": SPATIAL_BOX_M,
        "box_hits": int(want.numel()), "queries": int(q.shape[0]),
        "unique_minima": int(unique.sum()), "n_rings": n_rings,
        "bucket_cap": cap, "build_device_ms": cuda_ms(torch, build_index),
        "query_box_device_ms": cuda_ms(
            torch, lambda: sp.query_box(idx, blo.tolist(), bhi.tolist(),
                                        xy.shape[0])),
        "nearest_device_ms": cuda_ms(torch, nearest)}), flush=True)


def check_examples(torch, hk, dev):
    """Phase 14c: the five examples' ``main`` on the card, each validating
    itself; the ``hungarian`` launches of the two that solve assignments."""
    from rfs_slam_tpu_torch.examples import (
        linear_assignment_lexicographic, linear_assignment_murty,
        linear_assignment_partition, ospa_error, spatial_index)

    rec = {"phase14": "examples"}
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as d:
        for mod, kw in ((linear_assignment_murty, {}),
                        (linear_assignment_partition, {}),
                        (linear_assignment_lexicographic, {}),
                        (ospa_error, {}),
                        (spatial_index,
                         {"out_file": os.path.join(d, "tree.txt")})):
            name = mod.__name__.rsplit(".", 1)[-1]
            hk.launches = 0
            t0 = time.perf_counter()
            mod.main(verbose=False, device=dev, **kw)
            torch.cuda.synchronize()
            rec[name] = {"wall_s": time.perf_counter() - t0,
                         "hungarian_launches": hk.launches}
    for name in ("linear_assignment_murty", "linear_assignment_partition"):
        if rec[name]["hungarian_launches"] == 0:
            raise AssertionError(f"{name}: no hungarian launch on the card")
    print(json.dumps(rec), flush=True)


def check_writers(logs_out, dt):
    """Phase 14d: the native writers (built here) against the Python
    writers on a logged run, byte for byte, each writer's host seconds."""
    from rfs_slam_tpu_torch.io import logs, native

    if native.lib() is None:
        raise AssertionError("the native I/O library did not build")
    n = len(logs_out["best"])
    args = {"particlePose.dat": (np.arange(1, n + 1) * dt, logs_out["pose"],
                                 logs_out["w"])}
    args["landmarkEst.dat"] = (args["particlePose.dat"][0], logs_out["best"],
                               logs_out["mean"], logs_out["cov"],
                               logs_out["gm_w"], logs_out["alive"])
    writers = {"native": {"particlePose.dat": native.write_particle_poses,
                          "landmarkEst.dat": native.write_landmark_estimates},
               "python": {"particlePose.dat": logs.python_particle_poses,
                          "landmarkEst.dat": logs.python_landmark_estimates}}
    files, secs = {}, {}
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as d:
        for tag, fns in writers.items():
            for name, fn in fns.items():
                path = os.path.join(d, f"{tag}_{name}")
                t0 = time.perf_counter()
                fn(path, *args[name])
                secs[f"{tag} {name}"] = time.perf_counter() - t0
                with open(path, "rb") as f:
                    files[tag, name] = f.read()
    for name in args:
        if files["native", name] != files["python", name]:
            raise AssertionError(f"{name}: native and Python writers differ")
    print(json.dumps({
        "phase14": "native_io", "steps": n,
        "particles": int(logs_out["pose"].shape[1]),
        "landmark_rows": int(logs_out["alive"].sum()),
        "bytes": {name: len(files["native", name]) for name in args},
        "byte_equal": True, "host_s": secs,
        "library": os.path.basename(native.library_path())}), flush=True)


def library_phase(torch, hk, vp_fs, fs_logs, dev):
    """Phase 14: the library on the card (see the module docstring)."""
    from rfs_slam_tpu_torch.ops import jcbb as jc
    from rfs_slam_tpu_torch.ops import spatial as sp

    t0 = time.perf_counter()
    filt, state, stream = vp_fs
    prob = jcbb_problem(torch, filt, state, stream, LIBRARY_FRAME, dev)
    check_jcbb(torch, jc, prob, dev)
    check_spatial(torch, sp, filt, prob, dev)
    check_examples(torch, hk, dev)
    check_writers(*fs_logs)
    print(f"phase 14: {time.perf_counter() - t0:.1f} s", flush=True)


def check_launches(rec, map_mesh: bool):
    """Each kernel of a phase 15 record launched in its sharded run, as
    often a step as unsharded (``map_update2d`` twice as often under a map
    mesh: the block form's head and tail), or for a teacher-forced record
    once (twice) for each ``merge2d`` launch."""
    got = rec["launches_per_step"]
    want = rec.get("plain_launches_per_step") or {
        k: got["merge2d"] for k in got}
    for name, n in got.items():
        factor = 2 if map_mesh and name == "map_update2d" else 1
        if not n or n != factor * want[name]:
            raise AssertionError(f"phase 15: {name} launched {n} times a "
                                 f"step sharded, {want} unsharded")


def sharded_phase(torch):
    """Phase 15: :data:`SHARDED_PATHS` sharded over the most ranks of
    :data:`SHARDED_RANKS` that the cards hold (NCCL, one a card) against
    their unsharded runs (``parallel/dryrun.compare_paths``), one JSON
    line a path; on one card
    also over two ranks sharing it through gloo (NCCL refuses a card
    twice).  Then the replay on the particles x map mesh: on four cards a
    2 x 2 NCCL mesh, teacher-forced; on one card a 1 x 1 NCCL mesh (a free
    run, bit-equal to the unsharded one) and a 1 x 2 gloo mesh of two
    ranks sharing the card, teacher-forced.  Each path's kernels must
    launch in its sharded run (:func:`check_launches`)."""
    from rfs_slam_tpu_torch.parallel import dryrun

    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    runs = [dict(ranks=max(r for r in SHARDED_RANKS if r <= cards))]
    print(f"phase 15: {runs[0]['ranks']} NCCL ranks over {cards} cards",
          flush=True)
    if cards == 1:
        # gloo stages a CUDA tensor through the host and waits on it, so
        # this loop runs without the sync check
        runs.append(dict(ranks=2, backend="gloo", sync_check=False))
    jobs = [(run, SHARDED_PATHS) for run in runs]
    # the map mesh (the replay only)
    teacher = [(MAP_PATH[0], MAP_TEACHER[1])]
    if cards >= 4:
        jobs.append((dict(ranks=4, map_shards=2, teacher=MAP_TEACHER[0]),
                     teacher))
    else:
        jobs += [(dict(ranks=1, map_shards=1), [MAP_PATH]),
                 (dict(ranks=2, map_shards=2, backend="gloo",
                       sync_check=False, teacher=MAP_TEACHER[0]), teacher)]
    for run, run_paths in jobs:
        for rec in dryrun.compare_paths(run_paths, device_type="cuda",
                                      timeout_s=SHARDED_TIMEOUT_S, **run):
            rec["sync_check"] = run.get("sync_check", True)
            print(json.dumps({"phase15": rec.pop("path"), **rec}),
                  flush=True)
            if not rec["ok"]:
                raise AssertionError(f"phase 15: the sharded run differs "
                                     f"from the unsharded one: {rec}")
            if run.get("map_shards") == 1 and not all(
                    rec[f"max_abs_{k}"] == 0.0 for k in ("pose", "log_w",
                                                         "w")):
                raise AssertionError(f"phase 15: the 1 x 1 map mesh is not "
                                     f"the unsharded run bit for bit: {rec}")
            check_launches(rec, bool(run.get("map_shards")))
    print(f"phase 15: {time.perf_counter() - t0:.1f} s", flush=True)


def scaling_phase(torch):
    """Phase 17: ``parallel/scaling_bench.bench`` at :data:`SCALING` over
    the NCCL rank counts of 1, 2 and 4 that the cards hold, then over two
    gloo ranks sharing one card; each n's equality check must pass and
    each rank launch ``map_update2d`` and ``merge2d`` as often a step as
    the one-rank run at the same total P (the launch counts of that run,
    in this process, are read before and after)."""
    from rfs_slam_tpu_torch.parallel import dryrun
    from rfs_slam_tpu_torch.parallel import scaling_bench as sb

    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    per, slots, zc, steps = SCALING
    kernels = dryrun._kernel_modules()
    for k in kernels.values():
        k.launches = 0
    for ranks, backend in (([n for n in (1, 2, 4) if n <= cards], None),
                           ([2], "gloo")):
        for rec in sb.bench(ranks, per, slots, zc, steps, "cuda", backend,
                            timeout_s=SHARDED_TIMEOUT_S):
            print(json.dumps({"phase17": f"{rec['ranks']} ranks",
                              **rec}), flush=True)
            if not rec["equality"]["ok"]:
                raise AssertionError(f"phase 17: the {rec['ranks']}-rank "
                                     f"run differs from the one-rank run: "
                                     f"{rec['equality']}")
            want = rec["one_rank_launches_per_step"]
            for got in rec["rank_launches_per_step"]:
                for name in ("map_update2d", "merge2d"):
                    if not got[name] or got[name] != want[name]:
                        raise AssertionError(
                            f"phase 17: {name} launched {got[name]} times "
                            f"a step on a rank, {want[name]} on one rank")
    launches = {k: m.launches for k, m in kernels.items()}
    if not (launches["map_update2d"] and launches["merge2d"]):
        raise AssertionError(f"phase 17: the one-rank runs launched "
                             f"{launches}")
    print(f"phase 17: {time.perf_counter() - t0:.1f} s, one-rank launches "
          f"{launches}", flush=True)


def batchsim_cells(torch, batchsim, kernels, dev):
    """One 300-step cell of each filter kind through ``run_one``."""
    from rfs_slam_tpu_torch.io import sim2d_xml
    from rfs_slam_tpu_torch.io.xmlconfig import XmlConfig, load_sim2d

    for kind in ("rbphd", "fastslam"):
        cfg = XmlConfig(sim2d_xml.write_config(
            os.path.join(HERE, "build", f"batch_{kind}.xml"), kind))
        sim_cfg = dataclasses.replace(load_sim2d(cfg), timesteps=300, pd=0.9,
                                      clutter=1e-3)
        for m in kernels:
            m.launches = 0
        mean_err, final_err, map_err, wall = batchsim.run_one(
            kind, cfg, sim_cfg, traj_seed=0, noise_seed=1, z_capacity=48,
            n_particles=100, device=dev)
        rec = {"batchsim": kind, "steps": 299, "particles": 100,
               "pd": 0.9, "clutter": 1e-3, "mean_tail_err_m": mean_err,
               "final_err_m": final_err, "map_cola": map_err, "wall_s": wall,
               "launches": {m.__name__.rsplit(".", 1)[-1]: m.launches
                            for m in kernels}}
        print(json.dumps(rec), flush=True)
        if not np.isfinite([mean_err, final_err, map_err]).all():
            raise AssertionError(f"batchsim {kind}: non-finite errors")

def large_map_inputs(torch, rng, params, P, M, Zc, dev):
    """Random map-update inputs at ``P`` x ``M``: poses near the origin,
    the slots spread over 0.2-3 m around it (the sensor sees 0.5-2.5 m),
    half to all of them alive, and ``Zc`` measurements of particle 0's
    first landmarks with noise (the last two masked), so that columns
    hold many positive cells and both argmax paths run."""
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    r = rng.uniform(0.2, 3.0, (P, M))
    a = rng.uniform(-np.pi, np.pi, (P, M))
    w = rng.uniform(0.05, 1.0, (P, M))
    k = np.arange(Zc)
    z = np.stack([r[0, k] + rng.normal(0, 0.02, Zc),
                  a[0, k] + rng.normal(0, 0.01, Zc)], axis=-1)
    alive = np.arange(M)[None, :] < rng.integers(M // 2, M + 1, (P, 1))
    return (t(rng.normal(0, 0.05, (P, 3))), t(r * np.cos(a)),
            t(r * np.sin(a)), t(rng.uniform(0.005, 0.02, (P, M))),
            t(rng.uniform(-0.002, 0.002, (P, M))),
            t(rng.uniform(0.005, 0.02, (P, M))), t(w), t(w * 0.5),
            torch.as_tensor(alive, device=dev), t(z),
            torch.as_tensor(k < Zc - 2, device=dev), params, 8)


def pad_slots(torch, x, n):
    """``x`` with its last (slot) axis padded to ``n`` with zeros (dead
    slots where ``x`` is the alive mask)."""
    out = x.new_zeros(x.shape[:-1] + (n,))
    out[..., :x.shape[-1]] = x
    return out


def bits(torch, x):
    """``x`` as integers: float planes compared bit for bit."""
    x = x.contiguous()
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def assert_bit_equal(torch, name, small, large, fields, n):
    """Each of ``fields`` of ``small`` equal to the bit to the same field of
    ``large``, on its first ``n`` slots where the field has ``large``'s
    slot axis (the last)."""
    for f in fields:
        a, b = getattr(small, f), getattr(large, f)
        if b.shape[-1] != a.shape[-1]:
            b = b[..., :n]
        if not torch.equal(bits(torch, a), bits(torch, b)):
            raise AssertionError(f"{name}: the large form's {f} differs from "
                                 f"the small form's")


def merge_tier(plan):
    """Where a merge's large-form ``plan`` keeps a particle's fixpoint
    data (``csrc/merge_bitmask.cuh``'s tiers)."""
    if plan.workspace == 0:
        return "all in shared memory"
    return ("all in the workspace" if plan.smem == 16
            else "gate fields in the workspace")


def large_merge3d(torch, m3, GMState, rng, P, N, dev, n_alive, tiers,
                  what="random"):
    """merge3d's large form against its twin on random mixtures at ``P``
    x ``N``, its tier (added to ``tiers``) and workspace printed; returns
    the largest error."""
    plan = m3.launch_plan(P, N)
    tier = merge_tier(plan)
    tiers.add(tier)
    print(json.dumps({"merge3d_large": what, "particles": P, "slots": N,
                      "tier": tier, "workspace_bytes": plan.workspace}),
          flush=True)
    return compare_merge3d(
        torch, m3, f"large {what} N={N}, {tier}", random_mixtures3(
            torch, GMState, rng, P, N, dev, n_alive), 1.5, 1.5)[1]


def check_large_forms(torch, mu, mg, m3, GMState, filt, dev):
    """Phase 16.1: each large form against its twin on random states
    (M or N = 1,025 and 2,048 at P=16, 8,192 at P=2; the merges also with
    every slot alive at N=2,048, so that several passes run; merge3d in
    both tiers its twin can run, all in shared memory and, at 8,192, the
    gate fields in the workspace; merge2d also past 9,535 slots,
    LARGE_WS_TWIN, where its gate fields go to the workspace) and the
    block form as head and tail on 2 blocks of 2,048 of M=4,096, against
    its twin and the one launch.  Returns the largest error of each
    kernel."""
    from rfs_slam_tpu_torch.ops.kernels import build

    rng = np.random.default_rng(16)
    errs = {"map_update2d": [], "merge2d": [], "merge3d": []}
    tiers = set()      # merge3d's tiers the twin checks ran in
    params = filt._map_params
    for P, M, Zc in LARGE_TWIN_SHAPES:
        a = large_map_inputs(torch, rng, params, P, M, Zc, dev)
        err, nz = compare_map_update(torch, f"large M={M}",
                                     mu.fused_map_update2d(*a),
                                     mu.map_update2d_plain(*a))
        errs["map_update2d"].append(err)
        print(f"map_update2d large form == twin at P={P}, M={M}, Zc={Zc} "
              f"({int(a[8].sum())} alive slots, {int(nz.sum())} picks; max "
              f"abs error {err:.3g}; "
              f"{mu.launch_plan(P, M, Zc, 8, build.sm_count(dev))})",
              flush=True)
        n_alive = (M // 2, M)
        errs["merge2d"].append(compare_merge2d(
            torch, mg, f"large N={M}", random_mixtures(
                torch, GMState, rng, P, M, dev, n_alive), 1.5, 1.5)[1])
        errs["merge3d"].append(large_merge3d(
            torch, m3, GMState, rng, P, M, dev, n_alive, tiers))
    N = LARGE_PAD
    errs["merge2d"].append(compare_merge2d(
        torch, mg, f"all alive N={N}", random_mixtures(
            torch, GMState, rng, 16, N, dev, (N, N)), 1.5, 1.5)[1])
    errs["merge3d"].append(large_merge3d(
        torch, m3, GMState, rng, 16, N, dev, (N, N), tiers, "all alive"))
    if tiers != {"all in shared memory", "gate fields in the workspace"}:
        raise AssertionError(f"merge3d: the twin checks ran in {tiers}")
    P, N, spread = LARGE_WS_TWIN
    plan = mg.launch_plan(P, N)
    if plan.workspace == 0:
        raise AssertionError(f"merge2d: N={N} keeps all in shared memory")
    errs["merge2d"].append(compare_merge2d(
        torch, mg, f"large N={N}, gate fields in a {plan.workspace} B "
        f"workspace", random_mixtures(torch, GMState, rng, P, N, dev,
                                      (N - N // 8, N), spread), 1.5, 1.5)[1])
    P, M, B = LARGE_BLOCKS
    a = large_map_inputs(torch, rng, params, P, M, 40, dev)
    k = mu.map_update2d_blocks(*a, n_blocks=B)
    err, _ = compare_map_update(torch, "large block form", k,
                                mu.map_update2d_blocks(*a, n_blocks=B,
                                                       plain=True))
    one = mu.fused_map_update2d(*a)
    torch.cuda.synchronize()
    nz = one.cand_w > 0
    if not (torch.equal(k.unused, one.unused)
            and torch.equal(k.cand_m[nz], one.cand_m[nz])):
        raise AssertionError("map_update2d: the large block form's picks "
                             "differ from the one launch's")
    errs["map_update2d"].append(err)
    print(f"map_update2d block form == twin and one launch on {B} blocks of "
          f"{M // B} of M={M} (max abs error {err:.3g})", flush=True)
    return {k: max(v) for k, v in errs.items()}


def check_padding(torch, mu, mg, m3, gm_ops, filt, state, z, z_mask,
                  vp_filt, vp_gm):
    """Phase 16.2: the mid-run state of phase 3 (M=128) and its merge
    input, and Victoria Park's merge input of phase 5d (N=512), padded
    with dead slots to LARGE_PAD: the large forms' outputs on the first
    slots equal the small forms' to the bit (every plane, the column sums,
    the unused flags, the alive sets, every positive pick and its
    weight); the large forms against their twins on the padded states;
    each form's device time with its twin's and the bound.  Returns
    ``{kernel: (max abs error, ms, plain_ms, bound_ms, bound_by)}``."""
    gm, cfg, n = state.gm, filt.cfg, LARGE_PAD
    args = (state.particles.pose, gm.mean[0], gm.mean[1], gm.cov[0],
            gm.cov[1], gm.cov[2], gm.w, gm.w_prev, gm.alive, z, z_mask,
            filt._map_params, cfg.new_per_z)
    padded = (args[0], *[pad_slots(torch, x, n) for x in args[1:9]],
              *args[9:])
    small, large = mu.fused_map_update2d(*args), mu.fused_map_update2d(
        *padded)
    torch.cuda.synchronize()
    M = gm.w.shape[1]
    assert_bit_equal(torch, "map_update2d padded", small, large,
                     ("w", "w_prev", "pd", "K", "cov_upd", "z_exp", "col_sum",
                      "unused"), M)
    pos = small.cand_w > 0
    if not (torch.equal(bits(torch, small.cand_w)[pos],
                        bits(torch, large.cand_w)[pos])
            and torch.equal(small.cand_m[pos], large.cand_m[pos])):
        raise AssertionError("map_update2d padded: a positive pick differs")
    rows = {}
    err, _ = compare_map_update(torch, "padded mid-run", large,
                                mu.map_update2d_plain(*padded))
    rows["map_update2d"] = (err, *kernel_vs_twin_ms(
        torch, f"map_update2d large form (mid-run padded to {n})",
        lambda: mu.fused_map_update2d(*padded),
        lambda: mu.map_update2d_plain(*padded)),
        *map_update_bound(padded, large))
    small_ms = cuda_ms(torch, lambda: mu.fused_map_update2d(*args))
    stats = torch.zeros(3, dtype=torch.int32, device=state.gm.w.device)
    mu.fused_map_update2d(*padded, stats=stats)
    print(json.dumps({"padded": "map_update2d", "slots": [M, n],
                      "ntab_max": int(stats[0]),
                      "stash_in_workspace": int(stats[1]),
                      "chunks_max": int(stats[2]),
                      "positive_picks": int(pos.sum()), "bit_equal": True,
                      "small_ms": small_ms, "large_ms": rows[
                          "map_update2d"][1],
                      "large_bound_ms": rows["map_update2d"][3]}),
          flush=True)

    gm_full = filt._map_update(state, z, z_mask)[0]
    merges = (("merge2d", mg.merge2d, mg.merge2d_plain,
               gm_ops.compact(gm_full, gm_full.capacity),
               cfg.merge_threshold, cfg.merge_inflation, 7, 30),
              ("merge3d", m3.merge3d, m3.merge3d_plain, vp_gm,
               vp_filt.cfg.merge_threshold, vp_filt.cfg.merge_inflation, 25,
               60))
    for name, kern, twin, g, thr, infl, inv_flop, merge_flop in merges:
        gp = type(g)(*[pad_slots(torch, x, n) for x in (
            g.mean, g.cov, g.w, g.w_prev, g.alive)])
        ks, kl = kern(g, thr, infl), kern(gp, thr, infl)
        torch.cuda.synchronize()
        assert_bit_equal(torch, f"{name} padded", ks, kl,
                         ("mean", "cov", "w", "w_prev", "alive"), g.capacity)
        if bool(kl.alive[:, g.capacity:].any()):
            raise AssertionError(f"{name}: a padded slot came alive")
        compare = compare_merge2d if name == "merge2d" else compare_merge3d
        _, err = compare(torch, mg if name == "merge2d" else m3,
                         f"padded to {n}", gp, thr, infl)
        rows[name] = (err, *kernel_vs_twin_ms(
            torch, f"{name} large form (padded to {n})",
            lambda: kern(gp, thr, infl), lambda: twin(gp, thr, infl)),
            *merge_bound(gm_ops, gp, kl, thr, infl, inv_flop=inv_flop,
                         merge_flop=merge_flop, chunk=gp.w.shape[0]))
        plan = (mg if name == "merge2d" else m3).launch_plan(*gp.w.shape)
        print(json.dumps({"padded": name, "slots": [g.capacity, n],
                          "alive": int(g.alive.sum()), "bit_equal": True,
                          "passes": merge_passes(gm_ops, gp, thr, infl,
                                                 gp.w.shape[0]),
                          "tier": merge_tier(plan),
                          "workspace_bytes": plan.workspace,
                          "small_ms": cuda_ms(torch, lambda: kern(g, thr,
                                                                  infl)),
                          "large_ms": rows[name][1],
                          "large_bound_ms": rows[name][3]}), flush=True)
    return rows


def overflow_phase(torch, mu, mg, gm_ops, card, dev):
    """Phase 16.3: ``map_overflow_demo``'s card mode at the JAX script's
    shape (P=64, M=8,192, Zc=16) for OVERFLOW[3] steps under the sync
    debug mode: both 2-D kernels launch in their large form once a step,
    the state stays finite; the peak device memory beside the JAX
    script's analytic figures.  Then each large form's device time on the
    example state at that shape.  Returns ``{kernel: (launches, ms)}``,
    the launches as the run's large-form counters read them."""
    from rfs_slam_tpu_torch.apps import example_step as ex
    from rfs_slam_tpu_torch.ops.kernels import build
    from rfs_slam_tpu_torch.parallel import map_overflow_demo as demo

    P, M, Zc, steps = OVERFLOW
    sms = build.sm_count(dev)
    rec = {"overflow": "map_overflow_demo card", "card": card,
           "analytic": demo.analytic(P, M, Zc),
           "forms": demo.forms(P, M, Zc, sms=sms),
           **demo.run_card(P, M, Zc, steps, dev)}
    rec["median_ms_per_step"] = statistics.median(rec["ms_per_step"])
    print(json.dumps(rec), flush=True)
    if not rec["finite"]:
        raise AssertionError("overflow: the state is not finite")
    for name in ("map_update2d", "merge2d"):
        if not (rec["launches"][name] == rec["large_launches"][name]
                == steps):
            raise AssertionError(f"overflow: {name} launched "
                                 f"{rec['launches'][name]} times, "
                                 f"{rec['large_launches'][name]} in its "
                                 f"large form, in {steps} steps")
    filt = ex.build(P, M, Zc, dev)
    state, odo, z, z_mask = ex.example_inputs(filt, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = filt.predict(state, odo, ex.DT, gen=gen)
    gm, cfg = state.gm, filt.cfg
    args = (state.particles.pose, gm.mean[0], gm.mean[1], gm.cov[0],
            gm.cov[1], gm.cov[2], gm.w, gm.w_prev, gm.alive, z, z_mask,
            filt._map_params, min(cfg.new_per_z, M))
    gm_full = filt._map_update(state, z, z_mask)[0]
    merge_in = gm_ops.compact(gm_full, gm_full.capacity)
    thr, infl = cfg.merge_threshold, cfg.merge_inflation
    ms = {"map_update2d": cuda_ms(torch, lambda: mu.fused_map_update2d(
              *args), n=5),
          "merge2d": cuda_ms(torch, lambda: mg.merge2d(merge_in, thr, infl),
                             n=5)}
    stats = torch.zeros(3, dtype=torch.int32, device=dev)
    out = mu.fused_map_update2d(*args, stats=stats)
    merged = mg.merge2d(merge_in, thr, infl)
    bounds = {"map_update2d": map_update_bound(args, out),
              "merge2d": merge_bound(gm_ops, merge_in, merged, thr, infl,
                                     inv_flop=7, merge_flop=30,
                                     chunk=MERGE_TRACE_CHUNK)}
    passes = merge_passes(gm_ops, merge_in, thr, infl, MERGE_TRACE_CHUNK)
    print(json.dumps({"overflow_kernel_ms": ms, "card": card,
                      "bound_ms": {k: b[0] for k, b in bounds.items()},
                      "merge_input_alive": int(merge_in.alive.sum()),
                      "merge_alive_after": int(merged.alive.sum()),
                      "merge_passes": passes,
                      "merge_workspace_bytes": mg.launch_plan(P, M).workspace,
                      "map_update_ntab_max": int(stats[0]),
                      "map_update_stash_in_workspace": int(stats[1]),
                      "map_update_chunks_max": int(stats[2]),
                      "map_update_workspace_bytes": mu.launch_plan(
                          P, M, Zc, args[12], sms).workspace}),
          flush=True)
    return {k: (rec["large_launches"][k], v, bounds[k][0])
            for k, v in ms.items()}


def large_paths_phase(torch, app, loop, vp_app, mu, mg, m3, dev, sim_cfg,
                      replay_steps_per_s, vp_icov, vp_cfg, stream):
    """Phases 16.4-16.5: the bl_dump replay with maps of LARGE_REPLAY[0]
    slots (P=200, Zc=40) over its first LARGE_REPLAY[1] steps, each 2-D
    kernel launching once an update with measurements, in its large form,
    finite outputs, steps/s beside phase 5's and the median pose error (no
    gate on either); Victoria Park RB-PHD with maps of LARGE_VP[0] slots
    over its first LARGE_VP[1] frames, merge3d launching once a frame with
    measurements in its large form, finite outputs.  Returns the large
    forms' launches."""
    from rfs_slam_tpu_torch.filters.rbphd import RBPHDFilter
    from rfs_slam_tpu_torch.io.xmlconfig import XmlConfig

    m_cap, steps = LARGE_REPLAY
    filt = app.build_filter(sim_cfg, dev, map_capacity=m_cap)
    gt, inputs = app.load_bl_dump(BL_DUMP, steps + 1)
    n_updates = int(np.asarray(inputs[2]).any(axis=1).sum())
    for m in (mu, mg, m3):
        m.launches = m.large_launches = 0
    final, best, wall = timed_run(torch, loop, filt, inputs, 0, sim_cfg.dt,
                                  dev)
    launches = {"map_update2d": mu.large_launches,
                "merge2d": mg.large_launches}
    alive = final.gm.alive
    rec = {"large_replay": "native/bl_dump", "map_capacity": m_cap,
           "steps": len(best), "particles": filt.cfg.n_particles,
           "wall_s": wall, "steps_per_s": len(best) / wall,
           "phase5_steps_per_s": replay_steps_per_s,
           "median_pose_err_m": loop.median_pose_error(best, gt[1:]),
           "launches": {"map_update2d": mu.launches,
                        "merge2d": mg.launches},
           "large_launches": launches, "updates_with_measurements":
               n_updates,
           "final_alive_max": int(alive.sum(dim=1).max())}
    print(json.dumps(rec), flush=True)
    for name, n in launches.items():
        if not n == rec["launches"][name] == n_updates:
            raise AssertionError(f"large replay: {name} launched {n} times "
                                 f"in its large form, {n_updates} updates "
                                 f"had measurements")
    if not (np.isfinite(best).all()
            and bool(torch.isfinite(final.particles.log_w).all())
            and bool(torch.isfinite(final.gm.w[alive]).all())
            and bool(torch.isfinite(final.gm.mean[:, alive]).all())):
        raise AssertionError("large replay produced non-finite outputs")

    m_cap, n_frames = LARGE_VP
    vfilt, _, _ = vp_app.build(XmlConfig(vp_cfg), device=dev)
    vfilt = RBPHDFilter(vfilt.motion, vfilt.lmk, vfilt.meas, vfilt.gates,
                        dataclasses.replace(vfilt.cfg, map_capacity=m_cap))
    frames = vp_app.head(stream, n_frames)
    n_meas = int(frames.z_mask.any(axis=1).sum())
    m3.launches = m3.large_launches = 0
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    vstate, outs = vp_app.run(vfilt, vp_icov, frames, gen)
    torch.cuda.synchronize()
    vwall = time.perf_counter() - t0
    launches["merge3d"] = m3.large_launches
    print(json.dumps({"large_vp": "victoria_park synthetic stream seed 0",
                      "map_capacity": m_cap, "frames": n_frames,
                      "particles": vfilt.cfg.n_particles,
                      "frames_per_s": n_frames / vwall,
                      "merge3d_launches": m3.launches,
                      "merge3d_large_launches": m3.large_launches,
                      "frames_with_measurements": n_meas,
                      "rmse_m": vp_app.trajectory_rmse(frames, outs)[0]}),
          flush=True)
    if not m3.large_launches == m3.launches == n_meas:
        raise AssertionError(f"large VP: merge3d launched "
                             f"{m3.large_launches} times in its large form, "
                             f"{n_meas} frames had measurements")
    if not vp_finite(torch, vstate, outs):
        raise AssertionError("large VP produced non-finite outputs")
    return launches


def large_mesh_phase(torch):
    """Phase 16.6: the dry run's replay with maps of LARGE_MESH[0] slots
    on a 1 x 2 gloo mesh sharing the card, LARGE_MESH[2] steps
    teacher-forced after LARGE_MESH[1] free ones, against the unsharded
    run: every step's integer and bool fields equal, floats within phase
    15's tolerances (``dryrun.compare_states``)."""
    from rfs_slam_tpu_torch.parallel import dryrun

    m_cap, warm, steps = LARGE_MESH
    for rec in dryrun.compare_paths(
            [(MAP_PATH[0], steps)], 2, "cuda", timeout_s=SHARDED_TIMEOUT_S,
            backend="gloo", sync_check=False, map_shards=2, teacher=warm,
            map_capacity=m_cap):
        print(json.dumps({"phase16": rec.pop("path"), **rec}), flush=True)
        if not rec["ok"]:
            raise AssertionError(f"phase 16: the 1 x 2 map mesh at "
                                 f"{m_cap} slots differs from the "
                                 f"unsharded run: {rec}")
        check_launches(rec, True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gates", action="store_true",
                    help="also run the 4-seed simulation median")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from rfs_slam_tpu_torch.apps import rbphdslam2dsim as app
    from rfs_slam_tpu_torch.apps import sim2d_common as loop
    from rfs_slam_tpu_torch.apps import rbphdslam_victoriapark as vp_app
    from rfs_slam_tpu_torch.core.state import GMState
    from rfs_slam_tpu_torch.io import sim2d
    from rfs_slam_tpu_torch.io import victoria_park as vp_io
    from rfs_slam_tpu_torch.io.xmlconfig import XmlConfig
    from rfs_slam_tpu_torch.ops import gm as gm_ops
    from rfs_slam_tpu_torch.ops.kernels import build
    from rfs_slam_tpu_torch.ops.kernels import map_update2d as mu
    from rfs_slam_tpu_torch.ops.kernels import merge2d as mg
    from rfs_slam_tpu_torch.ops.kernels import merge3d as m3
    from rfs_slam_tpu_torch.apps import batchsim
    from rfs_slam_tpu_torch.ops import assignment as A
    from rfs_slam_tpu_torch.ops.kernels import hungarian as hk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)

    # ---- 2. build, one nvcc per kernel, all started together
    names = ("map_update2d", "merge2d", "merge3d", "hungarian")
    t0 = time.perf_counter()
    build.load_all(names)
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(names)} "
          f"kernels", flush=True)
    for name in names:
        secs, log = build.BUILD_LOG.get(name, (0.0, "(cached build)"))
        print(f"build {name}: {secs:.1f} s\n{log}", flush=True)
    elapsed("phase 2, the build")

    sim_cfg = sim2d.Sim2DConfig()
    dt = sim_cfg.dt
    filt = app.build_filter(sim_cfg, dev)

    # the launch floor: the same event pair around the smallest launch
    one = torch.zeros(1, device=dev)
    floor_ms = cuda_ms(torch, one.zero_)
    print(f"launch floor: device ms {floor_ms:.4f} (a one-element zero_)",
          flush=True)

    # ---- 3-4. kernels against their twins
    gen = torch.Generator(device=dev).manual_seed(0)
    state, z, z_mask = midrun(torch, app, loop, filt, gen, dt)
    mu_row = check_map_update(torch, mu, filt, state, z, z_mask)
    mu_block = check_map_update_block(torch, mu, filt, state, z, z_mask)
    mg_row = check_merge(torch, mg, gm_ops, GMState, filt, state, z, z_mask,
                         dev)

    # ---- 4b. merge3d on the Victoria Park merge input after 200 frames
    # and on edge mixtures (timed after 5c, on the mid-stream state)
    vp_plain, vp_scans, vp_cfg = vp_streams()
    vp_filt, vp_icov, ack = vp_app.build(XmlConfig(vp_cfg), device=dev)
    stream = vp_io.load(vp_plain, z_capacity=vp_app.Z_CAPACITY, ackerman=ack)
    gen = torch.Generator(device=dev).manual_seed(0)
    vp_state, _ = vp_app.run(vp_filt, vp_icov,
                             vp_app.head(stream, VP_MIDRUN_FRAMES), gen)
    m3_err = check_merge3d(
        torch, m3, GMState, vp_filt,
        vp_merge_input(torch, gm_ops, vp_filt, vp_state, stream,
                       VP_MIDRUN_FRAMES, dev), dev)

    elapsed("phases 3-4b")
    # ---- 5. the full replay through both 2-D kernels
    gt, inputs = app.load_bl_dump(BL_DUMP)
    n_updates = int(np.asarray(inputs[2]).any(axis=1).sum())
    mu.launches = mg.launches = m3.launches = 0
    held = reset_peak(torch, dev)
    final, best, wall = timed_run(torch, loop, filt, inputs, 0, dt, dev)
    path_check(torch, "replay native/bl_dump", final.gm, False, held, dev)
    launches = {"map_update2d": mu.launches, "merge2d": mg.launches}
    for name, n in launches.items():
        if n != n_updates:
            raise AssertionError(f"{name}: {n} launches in the replay, "
                                 f"{n_updates} updates had measurements")
    alive = final.gm.alive
    if not (np.isfinite(best).all()
            and bool(torch.isfinite(final.particles.log_w).all())
            and bool(torch.isfinite(final.gm.w[alive]).all())
            and bool(torch.isfinite(final.gm.mean[:, alive]).all())):
        raise AssertionError("replay produced non-finite outputs")
    err = loop.median_pose_error(best, gt[1:])
    steps = len(best)
    replay_steps_per_s = steps / wall
    print(json.dumps({
        "replay": "native/bl_dump", "steps": steps,
        "particles": filt.cfg.n_particles, "wall_s": wall,
        "steps_per_s": steps / wall, "median_pose_err_m": err,
        "divergence_bound_m": DIVERGENCE_BOUND_M,
        "bench_gate_m": REPLAY_GATE_M, "bench_gate_ok": err <= REPLAY_GATE_M,
        "final_alive_mean": float(alive.sum(dim=1).float().mean())}),
        flush=True)
    if not err <= DIVERGENCE_BOUND_M:
        raise AssertionError(f"replay median pose error {err} m > "
                             f"{DIVERGENCE_BOUND_M} m")

    elapsed("phase 5")
    # ---- 5c. the Victoria Park path, first VP_FRAMES frames
    frames = vp_app.head(stream, VP_FRAMES)
    n_meas_frames = int(frames.z_mask.any(axis=1).sum())
    gen = torch.Generator(device=dev).manual_seed(0)
    mu.launches = mg.launches = m3.launches = 0
    held = reset_peak(torch, dev)
    t0 = time.perf_counter()
    vp_state, outs = vp_app.run(vp_filt, vp_icov, frames, gen)
    torch.cuda.synchronize()
    vp_wall = time.perf_counter() - t0
    path_check(torch, "victoria_park rbphd", vp_state.gm, False, held, dev)
    launches["merge3d"] = m3.launches
    if m3.launches != n_meas_frames:
        raise AssertionError(f"merge3d: {m3.launches} launches on the "
                             f"Victoria Park path, {n_meas_frames} frames "
                             f"had measurements")
    if not vp_finite(torch, vp_state, outs):
        raise AssertionError("Victoria Park path produced non-finite "
                             "outputs")
    rmse, dr_rmse = vp_app.trajectory_rmse(frames, outs)
    print(json.dumps({
        "path": "victoria_park synthetic stream seed 0",
        "frames": len(frames.t), "frames_cut_from": len(stream.t),
        "particles": vp_filt.cfg.n_particles,
        "map_capacity": vp_filt.cfg.map_capacity, "wall_s": vp_wall,
        "frames_per_s": len(frames.t) / vp_wall, "rmse_m": rmse,
        "dead_reckoning_rmse_m": dr_rmse,
        "divergence_bound_m": VP_DIVERGENCE_BOUND_M,
        "merge3d_launches": m3.launches,
        "best_alive_mean": float(outs["alive"].sum(axis=1).mean()),
        "final_alive_mean": float(vp_state.gm.alive.sum(dim=1).float()
                                  .mean())}), flush=True)
    if not rmse < dr_rmse:
        raise AssertionError(f"Victoria Park RMSE {rmse} m is not below "
                             f"dead reckoning's {dr_rmse} m")
    if not rmse <= VP_DIVERGENCE_BOUND_M:
        raise AssertionError(f"Victoria Park RMSE {rmse} m > "
                             f"{VP_DIVERGENCE_BOUND_M} m")

    # ---- 5d. merge3d timed on the merge input of frame VP_FRAMES
    vp_gm = vp_merge_input(torch, gm_ops, vp_filt, vp_state, stream,
                           VP_FRAMES, dev)
    m3_row = time_merge3d(torch, m3, gm_ops, vp_filt, vp_gm, m3_err)

    # ---- 5e. the scan-dependent Pd on a stream with lidar scans
    scan_frames = vp_io.load(vp_scans, z_capacity=vp_app.Z_CAPACITY,
                             ackerman=ack)
    gen = torch.Generator(device=dev).manual_seed(0)
    scan_state, scan_outs = vp_app.run(vp_filt, vp_icov, scan_frames, gen)
    if not vp_finite(torch, scan_state, scan_outs):
        raise AssertionError("the scan stream produced non-finite outputs")
    print(json.dumps({
        "path": "victoria_park synthetic stream seed 0 with scans",
        "frames": len(scan_frames.t),
        "rmse_m": vp_app.trajectory_rmse(scan_frames, scan_outs)[0]}),
        flush=True)

    elapsed("phases 5c-5e")
    # ---- 7-8. FastSLAM 1.0 and MH-FastSLAM through the Hungarian kernel
    fs_filt, _, _, _, fs_tables, fs_rec, fs_logs, fs_dt = fastslam_run(
        torch, loop, hk, "fastslam", FS_STEPS, dev, logged=True)
    launches["hungarian"] = fs_rec["hungarian_launches"]
    mh_filt, mh_state, mh_din, mh_gen, _, mh_rec, _, _ = fastslam_run(
        torch, loop, hk, "mhfastslam", MH_STEPS, dev)
    for rec, bound_m in ((fs_rec, FS_DIVERGENCE_BOUND_M),
                         (mh_rec, MH_DIVERGENCE_BOUND_M)):
        rec["divergence_bound_m"] = bound_m
    mh_inputs = recorded_update(torch, hk, mh_filt, mh_state, mh_din, mh_gen)

    elapsed("phases 7-8")
    # ---- 11-12. Victoria Park FastSLAM 1.0 and MH-FastSLAM, main runs
    vp_runs, vp_tables, vp_fs = vp_fastslam_phases(torch, hk, vp_plain,
                                                   vp_cfg, dev)

    elapsed("phases 11-12")
    # ---- 9. the Hungarian kernel against its twin (timed alone); the
    # kernel table's row is timed on the FastSLAM tables
    hk_row = check_hungarian(
        torch, hk, A, hungarian_cases(torch, A, fs_tables, mh_inputs,
                                      vp_tables, dev),
        [(f"FastSLAM DA tables, step {FS_MID_STEP}", fs_tables),
         (f"VP FastSLAM DA tables, frame {VP_FS_TABLE_FRAME}", vp_tables)])

    # ---- 14. the library on phase 11's final state, before the seed
    # workers share the card
    library_phase(torch, hk, vp_fs, (fs_logs, fs_dt), dev)

    # the bounds' other seeds in worker processes, beside phases 10 and
    # 13: neither holds a time to a bound.  The longest runs first: VP
    # FastSLAM 1.0's, then the rest
    with seed_pool() as pool:
        vp_submitted = submit_vp_seeds(pool, vp_plain, vp_cfg, vp_runs, dev)
        sim_submitted = submit_sim_seeds(
            pool, ((fs_rec, "fastslam", FS_STEPS),
                   (mh_rec, "mhfastslam", MH_STEPS)), dev)
        # ---- 10. batchsim cells on the card
        batchsim_cells(torch, batchsim, (mu, mg, m3, hk), dev)
        # ---- 13. resume on the card, both Victoria Park apps
        vp_resume(torch, vp_plain, vp_cfg, dev)
        collect_sim_seeds(sim_submitted)
        collect_vp_seeds(vp_submitted)

    elapsed("phases 9, 14, 10, 13 and the seeds")
    # ---- 15. the one-hypothesis paths sharded, once the card is free
    sharded_phase(torch)
    elapsed("phase 15")

    # ---- 16. large maps: the kernels' large forms (M, N > 1,024)
    t16 = time.perf_counter()
    large_errs = check_large_forms(torch, mu, mg, m3, GMState, filt, dev)
    large_rows = check_padding(torch, mu, mg, m3, gm_ops, filt, state, z,
                               z_mask, vp_filt, vp_gm)
    overflow = overflow_phase(torch, mu, mg, gm_ops, card, dev)
    large_launches = large_paths_phase(
        torch, app, loop, vp_app, mu, mg, m3, dev, sim_cfg,
        replay_steps_per_s,
        vp_icov, vp_cfg, stream)
    large_mesh_phase(torch)
    print(json.dumps({"large_rows_ms": {
        k: {"padded": large_rows[k][1],
            "overflow": overflow.get(k, (0, None))[1],
            "before_redesign": PARENT_LARGE_MS[k]} for k in large_rows},
        "card": card}), flush=True)
    print(f"phase 16: {time.perf_counter() - t16:.1f} s", flush=True)
    elapsed("phase 16")

    # ---- 17. the weak-scaling harness at small depth
    scaling_phase(torch)
    elapsed("phase 17")

    # the accuracy of phases 7-8 (checked once every phase has printed):
    # every seed's run below dead reckoning, their median within the bound
    for rec in (fs_rec, mh_rec):
        worst, med = max(rec["seed_errors_m"]), rec["median_of_seeds_m"]
        if not worst < rec["dead_reckoning_m"]:
            raise AssertionError(f"{rec['path']}: median error {worst} m is "
                                 f"not below dead reckoning's")
        if not med <= rec["divergence_bound_m"]:
            raise AssertionError(f"{rec['path']}: median over seeds "
                                 f"{rec['seeds']} {med} m > "
                                 f"{rec['divergence_bound_m']} m")
    check_vp_accuracy(vp_runs)

    # ---- 6. the 4-seed simulation median
    if args.gates:
        data = sim2d.generate(sim_cfg, traj_seed=1, noise_seed=1,
                              z_capacity=app.Z_CAPACITY)
        sim_in = loop.sim_inputs(data)
        errs = []
        for seed in (1, 2, 3, 4):
            _, b, w_s = timed_run(torch, loop, filt, sim_in, seed, dt, dev)
            errs.append(loop.median_pose_error(b, data.gt_pose[1:]))
            print(f"gates: seed {seed}: {errs[-1]:.4f} m, "
                  f"{len(b) / w_s:.1f} steps/s", flush=True)
        med = float(np.median(errs))
        print(json.dumps({"gates": "sim2d traj_seed=1 noise_seed=1",
                          "seed_errors_m": errs, "median_pose_err_m": med,
                          "bench_gate_m": SEED_MEDIAN_GATE_M,
                          "bench_gate_ok": med <= SEED_MEDIAN_GATE_M}),
              flush=True)

    # no single PyTorch call computes any of these functions: library_ms
    # stays null.  The Hungarian replaces no pallas_call: the JAX package
    # runs its _hungarian_uv as a vmapped while_loop
    kernels = []
    for name, jax_fn, row in (
            ("map_update2d", "ops/pallas/map_update2d.py:309", mu_row),
            ("merge2d", "ops/pallas/merge2d.py:194", mg_row),
            ("merge3d", "ops/pallas/merge3d.py:200", m3_row),
            ("hungarian", "ops/assignment.py:44", hk_row)):
        err, ms, plain_ms, bound_ms, bound_by = row
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"rfs_slam_tpu_torch/csrc/{name}.cu",
            "replaces": f"rfs_slam_tpu/{jax_fn}",
            "launches": launches[name], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "floor_ms": floor_ms, "library_ms": None})
    # the block form: one rank's two launches on its 64 slots (phase 3b)
    kernels[0].update(block_max_abs_err=mu_block[0], block_ms=mu_block[1],
                      block_plain_ms=mu_block[2], block_bound_ms=mu_block[3],
                      block_bound_by=mu_block[4])
    # the large forms (phase 16): timed on the padded mid-run states and at
    # the overflow shape; launches in the large-map paths (16.4-16.5), and
    # apart from them those of the overflow run (16.3)
    plans = {"map_update2d": mu.launch_plan(*OVERFLOW[:3], 8,
                                            build.sm_count(dev)),
             "merge2d": mg.launch_plan(*OVERFLOW[:2]),
             "merge3d": m3.launch_plan(100, LARGE_VP[0])}
    for name, jax_fn in (("map_update2d", "ops/pallas/map_update2d.py:309"),
                         ("merge2d", "ops/pallas/merge2d.py:194"),
                         ("merge3d", "ops/pallas/merge3d.py:200")):
        err, ms, plain_ms, bound_ms, bound_by = large_rows[name]
        kernels.append({
            "name": f"{name} (large form)", "route": "cuda",
            "source": f"rfs_slam_tpu_torch/csrc/{name}.cu",
            "replaces": f"rfs_slam_tpu/{jax_fn}",
            "launches": large_launches[name],
            "launches_overflow": overflow.get(name, (None,))[0],
            "max_abs_err": max(err, large_errs[name]), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "floor_ms": floor_ms, "library_ms": None,
            "shape": f"padded to {LARGE_PAD} slots",
            "overflow_ms": overflow.get(name, (0, None))[1],
            "overflow_bound_ms": overflow.get(name, (0, None, None))[2],
            "workspace_bytes": plans[name].workspace})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
