"""The sharded paths' dry run (the counterpart of the JAX package's
``dryrun_multichip``): spawn one rank per GPU, run a path sharded at full
width over :mod:`rfs_slam_tpu_torch.parallel.mesh`, and hold it to the
unsharded run.

    python -m rfs_slam_tpu_torch.parallel.dryrun --ranks N \
        [--path replay|vp|fastslam] [--steps S] [--device cpu]

It needs as many GPUs as ranks (NCCL), or ``--device cpu`` (gloo ranks on
the CPU).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from rfs_slam_tpu_torch.parallel.mesh import (gather_state, init_process_group,
                                              make_mesh, shard_state)

HERE = os.path.dirname(os.path.abspath(__file__))
BL_DUMP = os.path.join(HERE, os.pardir, os.pardir, "native", "bl_dump")
PATHS = ("replay", "vp", "fastslam")
WARMUP_STEPS = 3
# the kernels each path launches
PATH_KERNELS = {"replay": ("map_update2d", "merge2d"), "vp": ("merge3d",),
                "fastslam": ("hungarian",)}


def prepare(paths, workdir: str) -> None:
    """Write the inputs the paths read into ``workdir`` once, before the
    ranks start: the synthetic Victoria Park stream and its config, the
    stand-in FastSLAM config."""
    from rfs_slam_tpu_torch.io import sim2d_xml, vp_synth

    for path, steps in paths:
        if path == "vp":
            vp_synth.write(os.path.join(workdir, "vp"), seed=0,
                           n_frames=steps)
            vp_synth.write_config(os.path.join(workdir, "vp", "config.xml"))
        elif path == "fastslam":
            sim2d_xml.write_config(os.path.join(workdir, "fastslam.xml"),
                                   "fastslam")


def setup(path: str, steps: int, device: torch.device, workdir: str):
    """``(filter, drive)`` of a path at full width on ``device``:
    ``drive(gen, mesh)`` puts the inputs on the device and returns
    ``run(on_step)``, which runs ``steps`` steps (frames) from the initial
    state, calls ``on_step(k, state)`` after each, and returns the final
    state (the rank's block under ``mesh``).

    * ``replay``: RB-PHD on ``native/bl_dump`` with bench.py's filter
      (P=200, M=128, Zc=40), ``sim2d_common.steps``;
    * ``vp``: RB-PHD on the seed-0 synthetic Victoria Park stream (P=100,
      M=512, Zc=24, D=3), ``_vp_common.make_frame_step``;
    * ``fastslam``: FastSLAM 1.0 on ``sim2d.generate(traj_seed=1,
      noise_seed=1)`` with the stand-in config (P=200, M=128, NMZ=32).
    """
    from rfs_slam_tpu_torch.apps import sim2d_common as loop

    if path == "replay":
        from rfs_slam_tpu_torch.apps import rbphdslam2dsim as app
        from rfs_slam_tpu_torch.io import sim2d

        sim_cfg = sim2d.Sim2DConfig()
        filt = app.build_filter(sim_cfg, device)
        _, inputs = app.load_bl_dump(BL_DUMP, steps + 1)
        din = loop.device_inputs(inputs, device)
        return filt, sim2d_drive(filt, din, sim_cfg.dt)
    if path == "fastslam":
        from rfs_slam_tpu_torch.apps import fastslam2dsim as fs_app
        from rfs_slam_tpu_torch.io import sim2d
        from rfs_slam_tpu_torch.io.xmlconfig import XmlConfig, load_sim2d

        cfg = XmlConfig(os.path.join(workdir, "fastslam.xml"))
        sim_cfg = load_sim2d(cfg)
        data = sim2d.generate(sim_cfg, traj_seed=1, noise_seed=1)
        zc = max(data.z.shape[1], 4)
        filt = fs_app.build_filter_from_xml(cfg, sim_cfg, z_capacity=zc,
                                            device=device)
        din = loop.device_inputs(loop.sim_inputs(data, steps + 1, zc),
                                 device)
        return filt, sim2d_drive(filt, din, sim_cfg.dt)
    if path == "vp":
        from rfs_slam_tpu_torch.apps import _vp_common
        from rfs_slam_tpu_torch.apps import rbphdslam_victoriapark as vp_app
        from rfs_slam_tpu_torch.io import victoria_park as vp_io
        from rfs_slam_tpu_torch.io.xmlconfig import XmlConfig

        d = os.path.join(workdir, "vp")
        filt, icov, ack = vp_app.build(
            XmlConfig(os.path.join(d, "config.xml")), device=device)
        frames = vp_app.head(vp_io.load(d, z_capacity=vp_app.Z_CAPACITY,
                                        ackerman=ack), steps)
        return filt, vp_drive(filt, vp_app.step_frame, frames, icov)
    raise ValueError(f"unknown path {path!r}; one of {PATHS}")


def sim2d_drive(filt, din, dt: float):
    """A ``drive`` over ``sim2d_common.steps`` on device inputs ``din``."""
    from rfs_slam_tpu_torch.apps import sim2d_common as loop

    def drive(gen, mesh):
        return lambda on_step: loop.steps(filt, din, gen, dt, on_step, mesh)
    return drive


def vp_drive(filt, step_frame, frames, input_cov):
    """A ``drive`` over a Victoria Park app's ``step_frame`` and
    ``frames``: ``_vp_common.make_frame_step`` puts the stream on the
    device, then each frame is stepped from the initial 3-D state."""
    from rfs_slam_tpu_torch.apps import _vp_common

    def drive(gen, mesh):
        step = _vp_common.make_frame_step(filt, step_frame, frames, gen,
                                          input_cov, mesh=mesh)

        def run(on_step):
            state = filt.init_state(torch.zeros(3, device=gen.device), dz=3,
                                    d=3)
            if mesh is not None:
                state = shard_state(state, mesh)
            for j in range(len(frames.t)):
                state = step(state, j)
                on_step(j, state)
            return state
        return run
    return drive


def _kernel_modules():
    from rfs_slam_tpu_torch.ops.kernels import (hungarian, map_update2d,
                                                merge2d, merge3d)
    return {"map_update2d": map_update2d, "merge2d": merge2d,
            "merge3d": merge3d, "hungarian": hungarian}


def _host(obj):
    """A state as a nested dict of numpy arrays."""
    return {f.name: _host(v) if dataclasses.is_dataclass(
        v := getattr(obj, f.name)) else v.detach().cpu().numpy()
        for f in dataclasses.fields(obj)}


def drive_path(path: str, steps: int, device: torch.device, workdir: str,
               sharded: bool = False, sync_check: bool = True) -> dict:
    """:func:`drive_logged` of a path (:func:`setup`), generator seed 0,
    after :data:`WARMUP_STEPS` steps of a run of its own: the one-time
    costs of a process's first steps stay out of the timed run."""
    for n in (WARMUP_STEPS, steps):
        filt, drive = setup(path, n, device, workdir)
        out = drive_logged(filt, drive, n, device, sharded,
                           sync_check=sync_check)
    return out


def drive_logged(filt, drive, steps: int, device: torch.device,
                 sharded: bool = False, seed: int = 0,
                 sync_check: bool = True) -> dict:
    """One run of ``drive(gen, mesh)`` (see :func:`setup`) from generator
    ``seed``, sharded over the process group's ranks with
    ``sharded``.  The loop reads nothing back: on the card it runs under
    torch's sync debug mode set to raise (``sync_check=False`` lifts it,
    for a backend whose collectives wait on the host).  Each step's
    parents, weights, poses and resampling flag are logged on the device
    and gathered once after the loop.  Returns numpy arrays ``parent [S,
    P]``, ``log_w [S, P]``, ``pose [S, P, 3]``, ``did [S]`` and the whole
    ``final`` state, with the loop's wall time, kernel launches, and
    (sharded) the collectives, ``p_local`` and the backend."""
    mesh = None
    p = filt.cfg.n_particles
    if sharded:
        mesh = make_mesh(p, device)
        p = mesh.p_local
        # the first collective sets the communicator up, outside the
        # timed loop and its sync check
        mesh.all_gather(torch.zeros(1, device=device))
    log = dict(parent=torch.empty((steps, p), dtype=torch.long,
                                  device=device),
               log_w=torch.empty((steps, p), device=device),
               pose=torch.empty((steps, p, 3), device=device),
               did=torch.empty((steps,), dtype=torch.bool, device=device))

    def on_step(k, state):
        log["parent"][k] = state.particles.parent
        log["log_w"][k] = state.particles.log_w
        log["pose"][k] = state.particles.pose
        # an update that resampled zeroes the counter; any other raises it
        log["did"][k] = state.n_updates == 0

    kernels = _kernel_modules()
    for k in kernels.values():
        k.launches = 0
    if mesh is not None:
        mesh.stats.update(collectives=0, bytes=0)
    gen = torch.Generator(device=device).manual_seed(seed)
    run = drive(gen, mesh)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        if sync_check:
            torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    try:
        state = run(on_step)
    finally:
        if cuda:
            torch.cuda.set_sync_debug_mode("default")
    if cuda:
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    out = {"launches": {k: m.launches for k, m in kernels.items()},
           "wall_s": wall}
    if mesh is not None:
        out.update(collectives=dict(mesh.stats), p_local=p,
                   backend=dist.get_backend(mesh.group))
        state = gather_state(state, mesh)
        log = {k: v if k == "did" else mesh.all_gather(v, 1)
               for k, v in log.items()}
    out.update({k: v.cpu().numpy() for k, v in log.items()})
    out["final"] = _host(state)
    return out


def _rank_main(rank: int, world: int, coordinator: str, device_type: str,
               paths, workdir: str, result_path: str,
               backend: str | None, sync_check: bool) -> None:
    """One rank of :func:`run_sharded`: join the group (even alone, so the
    collectives go through the backend), drive each path sharded, and
    (rank 0) pickle the results."""
    if device_type == "cpu":
        torch.set_num_threads(1)
        device = torch.device("cpu")
    else:
        device = torch.device("cuda", rank % torch.cuda.device_count())
    init_process_group(coordinator, world, rank, device, backend)
    try:
        results = {path: drive_path(path, steps, device, workdir, True,
                                    sync_check)
                   for path, steps in paths}
        if rank == 0:
            with open(result_path, "wb") as f:
                pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


def run_sharded(paths, ranks: int, device_type: str, workdir: str,
                timeout_s: float = 600.0, backend: str | None = None,
                sync_check: bool = True) -> dict:
    """Drive ``paths`` (``(path, steps)`` pairs) sharded over ``ranks``
    spawned processes, rank ``r`` on card ``r`` modulo the cards (or the
    CPU), over ``backend`` (default: the device's, see
    :func:`init_process_group`), the group met through a ``file://``
    rendezvous in ``workdir``.  Every process is killed after
    ``timeout_s``.  Returns rank 0's :func:`drive_path` results by
    path."""
    ctx = multiprocessing.get_context("spawn")
    coordinator = "file://" + os.path.join(workdir, "rendezvous")
    result_path = os.path.join(workdir, "sharded.pkl")
    procs = [ctx.Process(target=_rank_main, args=(
        r, ranks, coordinator, device_type, list(paths), workdir,
        result_path, backend, sync_check)) for r in range(ranks)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    late = [p for p in procs if p.is_alive()]
    for p in late:
        p.kill()
        p.join()
    codes = [p.exitcode for p in procs]
    if late or any(codes):
        raise RuntimeError(f"sharded run failed: exit codes {codes}"
                           + (f", {len(late)} killed after {timeout_s} s"
                              if late else ""))
    with open(result_path, "rb") as f:
        return pickle.load(f)


def _max_abs(a, b, relative: bool = False) -> float:
    """Largest |a - b| (with ``relative``, over max(1, |b|)), equal entries
    (infinities and NaNs too) counting 0 and a NaN against a number
    infinite."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    same = (a == b) | (np.isnan(a) & np.isnan(b))
    d = np.where(same, 0.0, np.abs(a - b))
    if relative:
        d = d / np.maximum(1.0, np.abs(np.where(same, 0.0, b)))
    return float(np.nan_to_num(d.max(), nan=np.inf)) if d.size else 0.0


# test_sharding.py's multistep tolerances
TOLERANCES = {"pose": 1e-4, "log_w": 1e-3, "w": 1e-4}
# every other float field of the final state: the pose tolerance, relative
# above magnitude 1
OTHER_TOLERANCE = 1e-4
_NAMED = {"particles.pose", "particles.log_w", "gm.w"}


def _leaves(tree: dict, prefix: str = ""):
    """``(dotted name, array)`` of every leaf of a :func:`_host` state."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def compare(sharded: dict, plain: dict) -> dict:
    """The sharded run against the unsharded one: ``parent``, ``did`` and
    every integer and bool field of the final state (``alive`` among them)
    equal; the largest absolute differences of pose and ``log_w`` (every
    step and final) and of the final map weights ``w`` within
    :data:`TOLERANCES`; every other float field of the final state (means,
    covariances, births, candidates) within :data:`OTHER_TOLERANCE`,
    relative above 1.  ``ok`` when all hold."""
    fs, fp = dict(_leaves(sharded["final"])), dict(_leaves(plain["final"]))
    if fs.keys() != fp.keys():
        raise ValueError(f"the states differ in their fields: "
                         f"{sorted(fs.keys() ^ fp.keys())}")
    differing = [k for k, a in fs.items() if a.dtype.kind in "biu"
                 and not np.array_equal(a, fp[k])]
    other = {k: _max_abs(a, fp[k], relative=True) for k, a in fs.items()
             if a.dtype.kind == "f" and k not in _NAMED}
    worst = max(other, key=other.get, default=None)
    rec = {
        "parent_equal": bool(np.array_equal(sharded["parent"],
                                            plain["parent"])),
        "did_equal": bool(np.array_equal(sharded["did"], plain["did"])),
        "alive_equal": "gm.alive" not in differing,
        "exact_fields_differing": differing,
        "max_abs_pose": max(_max_abs(sharded["pose"], plain["pose"]),
                            _max_abs(fs["particles.pose"],
                                     fp["particles.pose"])),
        "max_abs_log_w": max(_max_abs(sharded["log_w"], plain["log_w"]),
                             _max_abs(fs["particles.log_w"],
                                      fp["particles.log_w"])),
        "max_abs_w": _max_abs(fs["gm.w"], fp["gm.w"]),
        "max_rel_other": other.get(worst, 0.0),
        "max_rel_other_field": worst if other.get(worst) else None,
    }
    rec["ok"] = (rec["parent_equal"] and rec["did_equal"] and not differing
                 and rec["max_rel_other"] <= OTHER_TOLERANCE
                 and all(rec[f"max_abs_{k}"] <= t
                         for k, t in TOLERANCES.items()))
    return rec


def compare_paths(paths, ranks: int, device_type: str,
                  timeout_s: float = 600.0, backend: str | None = None,
                  sync_check: bool = True) -> list[dict]:
    """Each path sharded over ``ranks`` processes (:func:`run_sharded`)
    against its unsharded run in this process (on ``cuda:0`` or the CPU),
    one record each: ranks, backend, devices, steps, launches and
    collectives per step, bytes per step, steps/s sharded and unsharded,
    resamples, ancestors taken from another rank, and :func:`compare`'s
    checks."""
    device = torch.device("cuda", 0) if device_type == "cuda" else (
        torch.device("cpu"))
    if device_type == "cuda":
        from rfs_slam_tpu_torch.ops.kernels import build

        # built once here; the ranks load the libraries
        build.load_all(sorted({k for path, _ in paths
                               for k in PATH_KERNELS[path]}))
    with tempfile.TemporaryDirectory() as workdir:
        prepare(paths, workdir)
        sharded = run_sharded(paths, ranks, device_type, workdir, timeout_s,
                              backend, sync_check)
        records = []
        for path, steps in paths:
            plain = drive_path(path, steps, device, workdir)
            sh = sharded[path]
            p_local = sh["p_local"]
            step = np.arange(sh["parent"].shape[1])
            moved = (sh["parent"] // p_local) != (step // p_local)[None, :]
            rec = {"path": path, "ranks": ranks, "backend": sh["backend"],
                   "devices": [str(device) if device_type == "cpu" else
                               f"cuda:{r % torch.cuda.device_count()}"
                               for r in range(ranks)],
                   "steps": steps,
                   "particles": int(sh["parent"].shape[1]),
                   "p_local": p_local,
                   "launches_per_step": {
                       k: sh["launches"][k] / steps
                       for k in PATH_KERNELS[path]},
                   "plain_launches_per_step": {
                       k: plain["launches"][k] / steps
                       for k in PATH_KERNELS[path]},
                   "collectives_per_step":
                       sh["collectives"]["collectives"] / steps,
                   "collective_bytes_per_step":
                       sh["collectives"]["bytes"] / steps,
                   "steps_per_s_sharded": steps / sh["wall_s"],
                   "steps_per_s_unsharded": steps / plain["wall_s"],
                   "resamples": int(sh["did"].sum()),
                   "cross_rank_ancestors": int(moved[sh["did"]].sum()),
                   **compare(sh, plain)}
            records.append(rec)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, required=True)
    ap.add_argument("--path", action="append", choices=PATHS,
                    help="a path to run (repeatable; default: all three)")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="one GPU per rank (NCCL), or the CPU (gloo)")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds before every rank is killed")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < args.ranks:
            raise RuntimeError(
                f"{args.ranks} ranks need {args.ranks} GPUs, {have} found; "
                f"pass --device cpu to run the ranks on the CPU (gloo)")
        # the cards every number below ran on
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True).stdout.strip(), flush=True)
    else:
        torch.set_num_threads(1)
    paths = [(p, args.steps) for p in (args.path or PATHS)]
    ok = True
    for rec in compare_paths(paths, args.ranks, args.device, args.timeout):
        print(json.dumps(rec), flush=True)
        ok &= rec["ok"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
