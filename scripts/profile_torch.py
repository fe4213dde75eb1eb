"""The port's SLAM paths on one NVIDIA GPU: one whole run, then a phase
breakdown of a profiled window.

``--path vp`` (default): the Victoria Park path on the synthetic stream
(frames/s, trajectory RMSE against its GPS and dead reckoning's).
``--path replay``: the bench filter on the ``native/bl_dump`` replay
(steps/s, median pose error).
``--path fastslam``: FastSLAM 1.0 (``--hypotheses 1``) or MH-FastSLAM
(``--hypotheses 3``) at chip_smoke's width on ``sim2d.generate(
traj_seed=1, noise_seed=1)`` with the stand-in ``fastslam2dSim.xml``
(steps/s, median pose error beside dead reckoning's, the Hungarian
kernel's launches); its phases are the filter's spans ``fastslam.predict``,
``.da_table``, ``.assoc`` (the Hungarian or the gated Murty),
``.map_update`` (the EKF and existence updates of the chosen hypotheses),
``.prune``, ``.births`` (the landmark candidates) and ``.resample`` (with
the map copy); ``fastslam.update`` spans all but the first.
``--path vp_fastslam``: FastSLAM 1.0 (``--hypotheses 1``) or MH-FastSLAM
(``--hypotheses 3``) at the Victoria Park FastSLAM app's width (P=200,
M=512, Zc=24, a DA table of 32) on the synthetic stream (frames/s,
trajectory RMSE beside dead reckoning's, the Hungarian kernel's launches
beside the frames with measurements), with the FastSLAM phases.

The window is a second run of ``start + length`` frames (or steps) whose
last ``length`` run under ``torch.profiler``, which records the filters'
own spans (``utils/timing.py``; the RB-PHD ones ``rbphd.births``,
``.predict``, ``.map_update``, ``.importance``, ``.merge``, ``.prune``,
``.resample``, and ``rbphd.update`` around the last five) and tallies.  On
the replay the births run inside ``rbphd.predict``, so its span includes
theirs.  A Victoria Park window runs through the apps' chunked loop
(``_vp_common.chunked_scan``, its frames' outputs gathered on the device
and read back every ``--chunk`` frames), so its phases add the loop's
``vp.readback``.  Prints the card's name and power limit, one JSON line
for the whole run (on the VP path with ``merge3d``'s launches beside the
frames with measurements) and one for the window: host and device ms,
calls and device operations per frame for each phase, the device's busy
time and idle share, device operations per frame, the kernels that take
the most device time, the device time of the port's own CUDA kernels, and
the tallies per frame (births, merges in and out, resamplings).

Usage, from the repository root on a machine with the card::

    python3 scripts/profile_torch.py [--path vp] [--frames 7230]
        [--window 1000:20] [--chunk 50]
    python3 scripts/profile_torch.py --path replay --window 1000:60
    python3 scripts/profile_torch.py --path fastslam --hypotheses 3 \
        --frames 2000 --window 1000:40
    python3 scripts/profile_torch.py --path vp_fastslam [--hypotheses 3] \
        --frames 2000 --window 1000:40
"""

import argparse
import bisect
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rfs_slam_tpu_torch.apps import _vp_common  # noqa: E402
from rfs_slam_tpu_torch.apps import fastslam2dsim as fs_app  # noqa: E402
from rfs_slam_tpu_torch.apps import fastslam_victoriapark as fs_vp  # noqa
from rfs_slam_tpu_torch.apps import rbphdslam2dsim as app2d  # noqa: E402
from rfs_slam_tpu_torch.apps import sim2d_common as loop  # noqa: E402
from rfs_slam_tpu_torch.apps import rbphdslam_victoriapark as app  # noqa: E402
from rfs_slam_tpu_torch.io import sim2d, sim2d_xml  # noqa: E402
from rfs_slam_tpu_torch.io import victoria_park as vp_io  # noqa: E402
from rfs_slam_tpu_torch.io import vp_synth  # noqa: E402
from rfs_slam_tpu_torch.io.xmlconfig import XmlConfig, load_sim2d  # noqa: E402
from rfs_slam_tpu_torch.ops.kernels import hungarian, merge3d  # noqa: E402
from rfs_slam_tpu_torch.utils import timing  # noqa: E402

# the filters' own spans (filters/rbphd.py, filters/fastslam.py)
PHASES = ("rbphd.births", "rbphd.predict", "rbphd.map_update",
          "rbphd.importance", "rbphd.merge", "rbphd.prune", "rbphd.resample",
          "rbphd.update")
FS_PHASES = ("fastslam.predict", "fastslam.da_table", "fastslam.assoc",
             "fastslam.map_update", "fastslam.prune", "fastslam.births",
             "fastslam.resample", "fastslam.update")
# every span's device-side mirror, left out of the device operations
SPANS = frozenset(PHASES + FS_PHASES + ("vp.readback",))


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def stepwise(step):
    """A window that runs ``step(state, j)`` for each of its frames."""
    def window(state, start, length):
        for j in range(start, start + length):
            state = step(state, j)
        return state
    return window


def chunked(step, outputs, gen, chunk):
    """A window through the app's chunked loop
    (``_vp_common.chunked_scan``): ``step`` for each frame, ``outputs``
    gathered on the device and read back every ``chunk`` frames inside the
    ``vp.readback`` span."""
    def window(state, start, length):
        def frame_step(state, i):
            state = step(state, start + i)
            return state, outputs(state)
        return _vp_common.chunked_scan(frame_step, state, gen, length,
                                       ckpt_every=chunk, progress=False)[0]
    return window


def vp_stream(args):
    """The synthetic Victoria Park stream of ``--seed`` (written under
    build/ once) and its config."""
    data = os.path.join(ROOT, "build", "vp_synth", f"seed{args.seed}")
    if not os.path.exists(os.path.join(data, "gps.dat")):
        vp_synth.write(data, seed=args.seed)
    return data, XmlConfig(vp_synth.write_config(os.path.join(data,
                                                              "config.xml")))


def vp_path(args, dev):
    """(whole-run record, warm(start) -> the state before frame
    ``start``, window(state, start, length) -> the state after the window)
    of the Victoria Park path."""
    data, cfg = vp_stream(args)
    filt, icov, ack = app.build(cfg, device=dev)
    stream = vp_io.load(data, z_capacity=app.Z_CAPACITY, ackerman=ack)
    frames = app.head(stream, args.frames)

    gen = torch.Generator(device=dev).manual_seed(0)
    merge3d.launches = 0
    (state, outs), wall = timed(lambda: app.run(filt, icov, frames, gen))
    rmse, dr = app.trajectory_rmse(frames, outs)
    record = {
        "run": "victoria_park synthetic", "frames": len(frames.t),
        "frames_with_measurements": int(frames.z_mask.any(axis=1).sum()),
        "merge3d_launches": merge3d.launches,
        "wall_s": wall, "frames_per_s": len(frames.t) / wall,
        "rmse_m": rmse, "dead_reckoning_rmse_m": dr,
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "final_alive_mean": float(state.gm.alive.sum(dim=1).float().mean())}

    gen = torch.Generator(device=dev).manual_seed(0)
    step = _vp_common.make_frame_step(filt, app.step_frame, frames, gen, icov)

    def warm(start):
        state = filt.init_state(torch.zeros(3, device=dev), dz=3, d=3)
        for j in range(start):
            state = step(state, j)
        return state

    return record, warm, chunked(
        step, lambda s: _vp_common.frame_outputs(
            s, torch.exp(s.particles.log_w)), gen, args.chunk)


def vp_fastslam_path(args, dev):
    """The same three for Victoria Park FastSLAM (``--hypotheses``) on the
    first ``--frames`` frames of the synthetic stream."""
    data, cfg = vp_stream(args)
    filt, icov, ack = fs_vp.build(cfg, hypotheses=args.hypotheses,
                                  device=dev)
    frames = app.head(vp_io.load(data, z_capacity=fs_vp.Z_CAPACITY,
                                 ackerman=ack), args.frames)
    gen = torch.Generator(device=dev).manual_seed(0)
    hungarian.launches = 0
    (state, outs), wall = timed(lambda: fs_vp.run(filt, icov, frames, gen,
                                                  progress=False))
    rmse, dr = app.trajectory_rmse(frames, outs)
    best = int(torch.argmax(state.particles.log_w))
    record = {
        "run": f"victoria_park fastslam H={args.hypotheses} synthetic",
        "frames": len(frames.t), "particles": filt.cfg.n_particles,
        "particle_axis": filt.p_cap,
        "frames_with_measurements": int(frames.z_mask.any(axis=1).sum()),
        "hungarian_launches": hungarian.launches, "wall_s": wall,
        "frames_per_s": len(frames.t) / wall, "rmse_m": rmse,
        "dead_reckoning_rmse_m": dr,
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "best_alive": int(state.gm.alive[best].sum())}

    gen = torch.Generator(device=dev).manual_seed(0)
    step = _vp_common.make_frame_step(filt, fs_vp.step_frame, frames, gen,
                                      icov)

    def warm(start):
        state = filt.init_state(torch.zeros(3, device=dev), d=3)
        for j in range(start):
            state = step(state, j)
        return state

    def outputs(state):
        lw = state.particles.log_w
        return _vp_common.frame_outputs(
            state, torch.exp(lw - torch.logsumexp(lw, dim=0)),
            map_w=torch.sigmoid)

    return record, warm, chunked(step, outputs, gen, args.chunk)


def replay_path(args, dev):
    """The same three for the bench filter on the ``native/bl_dump``
    replay (the window must start after the ground-truth lock)."""
    if int(args.window.split(":")[0]) < loop.GT_LOCK_STEPS:
        raise SystemExit("--window must start after the ground-truth lock "
                         f"(step {loop.GT_LOCK_STEPS})")
    dt = sim2d.Sim2DConfig().dt
    filt = app2d.build_filter(sim2d.Sim2DConfig(), dev)
    gt, inputs = app2d.load_bl_dump(os.path.join(ROOT, "native", "bl_dump"))
    gen = torch.Generator(device=dev).manual_seed(0)
    (state, best), wall = timed(lambda: loop.run(filt, inputs, gen, dt))
    record = {
        "run": "native/bl_dump replay", "steps": len(best), "wall_s": wall,
        "steps_per_s": len(best) / wall,
        "median_pose_err_m": loop.median_pose_error(best, gt[1:]),
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "final_alive_mean": float(state.gm.alive.sum(dim=1).float().mean())}

    put = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt,
                                                      device=dev)
    odo, z, zm = put(inputs[0]), put(inputs[1]), put(inputs[2], torch.bool)
    has_z = np.asarray(inputs[2]).any(axis=1)
    gen = torch.Generator(device=dev).manual_seed(0)

    def warm(start):
        # the steps before the window, ground-truth lock included
        return loop.run(filt, tuple(a[:start] for a in inputs), gen, dt)[0]

    def step(state, k):
        state = filt.predict(state, odo[k], dt, gen=gen)
        return filt.update(state, z[k], zm[k], gen=gen, has_z=bool(has_z[k]))

    return record, warm, stepwise(step)


def fastslam_path(args, dev):
    """The same three for FastSLAM (``--hypotheses``) on the first
    ``--frames`` steps of sim2d traj_seed=1, noise_seed=1."""
    kind = "fastslam" if args.hypotheses == 1 else "mhfastslam"
    cfg = XmlConfig(sim2d_xml.write_config(
        os.path.join(ROOT, "build", f"{kind}2dSim.xml"), kind,
        {"filter.update.maxNDataAssocHypotheses": args.hypotheses}))
    sim_cfg = load_sim2d(cfg)
    data = sim2d.generate(sim_cfg, traj_seed=1, noise_seed=1)
    zc = max(data.z.shape[1], 4)
    filt = fs_app.build_filter_from_xml(cfg, sim_cfg, z_capacity=zc,
                                        device=dev)
    inputs = loop.sim_inputs(data, steps=args.frames + 1, z_capacity=zc)
    gen = torch.Generator(device=dev).manual_seed(0)
    hungarian.launches = 0
    (state, best), wall = timed(lambda: loop.run(filt, inputs, gen,
                                                 sim_cfg.dt))
    gt = data.gt_pose[1:len(best) + 1]
    record = {
        "run": f"{kind} sim2d traj_seed=1 noise_seed=1", "steps": len(best),
        "particles": filt.cfg.n_particles, "particle_axis": filt.p_cap,
        "updates_with_measurements": int(inputs[2].any(axis=1).sum()),
        "hungarian_launches": hungarian.launches, "wall_s": wall,
        "steps_per_s": len(best) / wall,
        "median_pose_err_m": loop.median_pose_error(best, gt),
        "dead_reckoning_m": loop.median_pose_error(
            data.dr_pose[1:len(best) + 1], gt),
        "peak_device_bytes": torch.cuda.max_memory_allocated()}
    din = loop.device_inputs(inputs, dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def warm(start):
        # the steps before the window, ground-truth lock included
        return loop.run(filt, tuple(a[:start] for a in inputs), gen,
                        sim_cfg.dt)[0]

    def step(state, k):
        state = filt.predict(state, din[0][k], sim_cfg.dt, gen=gen)
        return filt.update(state, din[1][k], din[2][k], gen=gen,
                           has_z=bool(din[-1][k]))

    return record, warm, stepwise(step)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--path", choices=("vp", "replay", "fastslam",
                                       "vp_fastslam"), default="vp")
    ap.add_argument("--frames", type=int, default=7230,
                    help="frames of the whole VP run (steps of the "
                         "FastSLAM run; at most 2999)")
    ap.add_argument("--hypotheses", type=int, default=1,
                    help="FastSLAM's data-association hypotheses (3: "
                         "MH-FastSLAM)")
    ap.add_argument("--window", default="1000:20", help="START:LENGTH")
    ap.add_argument("--seed", type=int, default=0,
                    help="the VP stream's seed")
    ap.add_argument("--chunk", type=int, default=50,
                    help="VP frames a read-back in the window (the "
                         "benchmark's VP chunk)")
    args = ap.parse_args()
    start, length = (int(x) for x in args.window.split(":"))

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    path = {"vp": vp_path, "replay": replay_path, "fastslam": fastslam_path,
            "vp_fastslam": vp_fastslam_path}[args.path]
    fastslam = args.path in ("fastslam", "vp_fastslam")
    phases = FS_PHASES if fastslam else PHASES
    if args.path in ("vp", "vp_fastslam"):
        phases += ("vp.readback",)
    record, warm, window = path(args, dev)
    print(json.dumps({**record, "card": card}), flush=True)

    # the profiled window
    state = warm(start)
    timing.tallies()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state = window(state, start, length)
        torch.cuda.synchronize()
        win = time.perf_counter() - t0
    tallied = timing.tallies()
    # host ms: the spans' own wall on the host.  device ms and launches: the
    # device operations inside the span's mirror on the device timeline
    # (first to last of its kernels); "device_ms_ops" and "launches_ops"
    # the same from the host side (the kernels of the span's ops, nested
    # spans' included).  The mirrors are left out of the busy sum.  A span
    # nested in one of its own name counts once.
    events = prof.events()
    dev_t = torch.autograd.DeviceType.CUDA
    kernels = [e for e in events
               if e.device_type == dev_t and e.name not in SPANS]

    def kernels_of(e):
        return len(e.kernels) + sum(kernels_of(c) for c in e.cpu_children)

    def nested(e):
        p = e.cpu_parent
        while p is not None:
            if p.name == e.name:
                return True
            p = p.cpu_parent
        return False

    per = {}
    for name in phases:
        host = [e for e in events if e.name == name
                and e.device_type != dev_t and not nested(e)]
        spans = []
        for a, b in sorted((e.time_range.start, e.time_range.end)
                           for e in events
                           if e.name == name and e.device_type == dev_t):
            if spans and a <= spans[-1][1]:      # overlapping: merge
                spans[-1] = (spans[-1][0], max(spans[-1][1], b))
            else:
                spans.append((a, b))
        starts = [a for a, _ in spans]
        inside, launches = 0.0, 0
        for k in kernels:
            i = bisect.bisect_right(starts, k.time_range.start) - 1
            if i >= 0 and k.time_range.start < spans[i][1]:
                inside += k.device_time
                launches += 1
        per[name] = {
            "host_ms": sum(e.cpu_time_total for e in host) / 1e3 / length,
            "device_ms": inside / 1e3 / length,
            "device_ms_ops": sum(e.device_time_total for e in host)
            / 1e3 / length,
            "calls": len(host) / length,
            "launches": launches / length,
            "launches_ops": sum(kernels_of(e) for e in host) / length}
    busy = sum(e.device_time for e in kernels) / 1e3
    by_name = {}
    for k in kernels:
        t, n = by_name.get(k.name, (0.0, 0))
        by_name[k.name] = (t + k.device_time, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    # the port's own kernels (csrc/*.cu), by the name in their symbol
    ours = {}
    for n, (t, c) in by_name.items():
        for kernel in ("map_update2d", "merge2d", "merge3d", "hungarian"):
            if f"{kernel}_kernel" in n:
                t0, c0 = ours.get(kernel, (0.0, 0))
                ours[kernel] = (t0 + t, c0 + c)
    print(json.dumps({
        "window": f"{args.path} {start}-{start + length - 1}", "card": card,
        "profiled_ms_per_frame": win * 1e3 / length,
        "device_busy_ms_per_frame": busy / length,
        "device_idle_share": 1.0 - busy / (win * 1e3),
        "kernel_launches_per_frame": len(kernels) / length,
        "phases": per,
        "top_kernels": [{"name": n[:80], "device_ms": t / 1e3 / length,
                         "launches": c / length} for n, (t, c) in top],
        "port_kernels": {k: {"device_ms": t / 1e3 / length,
                             "launches": c / length}
                         for k, (t, c) in ours.items()},
        "tallies_per_frame": {k: v / length for k, v in tallied.items()}}),
        flush=True)


if __name__ == "__main__":
    main()
