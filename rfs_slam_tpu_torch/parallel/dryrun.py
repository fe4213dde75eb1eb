"""The sharded paths' dry run (the counterpart of the JAX package's
``dryrun_multichip``): spawn one rank per GPU, run a path sharded at full
width over :mod:`rfs_slam_tpu_torch.parallel.mesh`, and hold it to the
unsharded run.

    python -m rfs_slam_tpu_torch.parallel.dryrun --ranks N \
        [--path replay|vp|fastslam|mh] [--steps S] [--device cpu] \
        [--map-shards B [--teacher-forced W]] [--map-capacity M]

It needs as many GPUs as ranks (NCCL), or ``--device cpu`` (gloo ranks on
the CPU).  ``--map-shards B`` runs the replay on the ``N / B`` x ``B``
particles x map mesh; ``--teacher-forced W`` then steps it from the
unsharded run's state at every step after ``W`` free steps, and holds
each step to the unsharded one (:func:`teacher_forced`).
``--map-capacity M`` runs the replay with maps of ``M`` slots in place of
the bench filter's 128 (the kernels' large forms past 1,024).
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
                                              make_mesh, make_mesh_2d,
                                              shard_state)

HERE = os.path.dirname(os.path.abspath(__file__))
BL_DUMP = os.path.join(HERE, os.pardir, os.pardir, "native", "bl_dump")
PATHS = ("replay", "vp", "fastslam", "mh")
WARMUP_STEPS = 3
# the kernels each path launches
PATH_KERNELS = {"replay": ("map_update2d", "merge2d"), "vp": ("merge3d",),
                "fastslam": ("hungarian",), "mh": ("hungarian",)}
# the stand-in config of each FastSLAM path (io/sim2d_xml.py's kinds)
FASTSLAM_KINDS = {"fastslam": "fastslam", "mh": "mhfastslam"}
# the paths a particles x map mesh runs
MAP_PATHS = ("replay",)


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
        elif path in FASTSLAM_KINDS:
            sim2d_xml.write_config(os.path.join(workdir, f"{path}.xml"),
                                   FASTSLAM_KINDS[path])


def setup(path: str, steps: int, device: torch.device, workdir: str,
          map_capacity: int | None = None):
    """``(filter, drive)`` of a path at full width on ``device``:
    ``drive(gen, mesh)`` puts the inputs on the device and returns
    ``run(on_step)``, which runs ``steps`` steps (frames) from the initial
    state, calls ``on_step(k, state)`` after each, and returns the final
    state (the rank's block under ``mesh``).

    * ``replay``: RB-PHD on ``native/bl_dump`` with bench.py's filter
      (P=200, M=128 or ``map_capacity``, Zc=40), ``sim2d_common.steps``;
    * ``vp``: RB-PHD on the seed-0 synthetic Victoria Park stream (P=100,
      M=512, Zc=24, D=3), ``_vp_common.make_frame_step``;
    * ``fastslam``: FastSLAM 1.0 on ``sim2d.generate(traj_seed=1,
      noise_seed=1)`` with the stand-in config (P=200, M=128, NMZ=32);
    * ``mh``: MH-FastSLAM the same way (H=3, 200 live of P_cap=600, lane
      budget 200).
    """
    from rfs_slam_tpu_torch.apps import sim2d_common as loop

    if map_capacity and path != "replay":
        raise ValueError(f"--map-capacity sizes the replay's maps, not "
                         f"{path!r}'s")
    if path == "replay":
        from rfs_slam_tpu_torch.apps import rbphdslam2dsim as app
        from rfs_slam_tpu_torch.io import sim2d

        sim_cfg = sim2d.Sim2DConfig()
        filt = app.build_filter(sim_cfg, device, map_capacity=map_capacity)
        _, inputs = app.load_bl_dump(BL_DUMP, steps + 1)
        din = loop.device_inputs(inputs, device)
        return filt, sim2d_drive(filt, din, sim_cfg.dt)
    if path in FASTSLAM_KINDS:
        from rfs_slam_tpu_torch.apps import fastslam2dsim as fs_app
        from rfs_slam_tpu_torch.io import sim2d
        from rfs_slam_tpu_torch.io.xmlconfig import XmlConfig, load_sim2d

        cfg = XmlConfig(os.path.join(workdir, f"{path}.xml"))
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
    """A ``drive`` over ``sim2d_common.steps`` on device inputs ``din``
    (kept as its ``din`` and ``dt``)."""
    from rfs_slam_tpu_torch.apps import sim2d_common as loop

    def drive(gen, mesh):
        return lambda on_step: loop.steps(filt, din, gen, dt, on_step, mesh)
    drive.din, drive.dt = din, dt
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
               sharded: bool = False, sync_check: bool = True,
               map_shards: int = 0, map_capacity: int | None = None) -> dict:
    """:func:`drive_logged` of a path (:func:`setup`), generator seed 0,
    after :data:`WARMUP_STEPS` steps of a run of its own: the one-time
    costs of a process's first steps stay out of the timed run."""
    for n in (WARMUP_STEPS, steps):
        filt, drive = setup(path, n, device, workdir, map_capacity)
        out = drive_logged(filt, drive, n, device, sharded,
                           sync_check=sync_check, map_shards=map_shards)
    return out


def sharded_mesh(filt, device: torch.device, map_shards: int = 0):
    """The mesh of a sharded run over the process group's ranks: the
    particle mesh, or with ``map_shards`` the ``ranks / map_shards`` x
    ``map_shards`` particles x map mesh.  Its first collectives (one on
    each axis) set the communicators up."""
    p = getattr(filt, "p_cap", filt.cfg.n_particles)
    if map_shards:
        mesh = make_mesh_2d(dist.get_world_size() // map_shards, map_shards,
                            p, filt.cfg.map_capacity, device)
        mesh.map_all_gather(torch.zeros(1, device=device))
    else:
        mesh = make_mesh(p, device)
    mesh.all_gather(torch.zeros(1, device=device))
    return mesh


def drive_logged(filt, drive, steps: int, device: torch.device,
                 sharded: bool = False, seed: int = 0,
                 sync_check: bool = True, map_shards: int = 0) -> dict:
    """One run of ``drive(gen, mesh)`` (see :func:`setup`) from generator
    ``seed``, sharded over the process group's ranks with
    ``sharded``.  The loop reads nothing back: on the card it runs under
    torch's sync debug mode set to raise (``sync_check=False`` lifts it,
    for a backend whose collectives wait on the host).  Each step's
    parents, weights, poses and resampling flag are logged on the device
    and gathered once after the loop.  Returns numpy arrays ``parent [S,
    P]``, ``log_w [S, P]``, ``pose [S, P, 3]``, ``did [S]`` and the whole
    ``final`` state, with the loop's wall time, kernel launches, and
    (sharded) the collectives, ``p_local`` and the backend; with
    ``map_shards``, over the particles x map mesh (:func:`sharded_mesh`)."""
    mesh = None
    p = getattr(filt, "p_cap", filt.cfg.n_particles)
    if sharded:
        # its first collectives outside the timed loop and its sync check
        mesh = sharded_mesh(filt, device, map_shards)
        p = mesh.p_local
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
           "wall_s": wall, "map_capacity": filt.cfg.map_capacity}
    if mesh is not None:
        out.update(collectives=dict(mesh.stats), p_local=p,
                   backend=dist.get_backend(mesh.group))
        state = gather_state(state, mesh)
        log = {k: v if k == "did" else mesh.all_gather(v, 1)
               for k, v in log.items()}
    out.update({k: v.cpu().numpy() for k, v in log.items()})
    out["final"] = _host(state)
    return out


# tests/test_sharding.py's one-step tolerances (absolute; ``w`` relative
# 1e-4 with 1e-5 absolute), for a step from the same state
STEP_TOLERANCES = {"particles.pose": 1e-5, "particles.log_w": 1e-4,
                   "gm.mean": 1e-4}


def compare_states(sharded: dict, plain: dict) -> dict:
    """A step's state (:func:`_host`) against the unsharded step's from
    the same state and draws: every integer and bool field equal (``alive``
    and ``parent`` among them); pose, ``log_w`` and the means within
    :data:`STEP_TOLERANCES`, ``w`` within 1e-4 relative and 1e-5 absolute,
    every other float field within :data:`OTHER_TOLERANCE` (relative above
    1).  ``ok`` when all hold."""
    fs, fp = dict(_leaves(sharded)), dict(_leaves(plain))
    differing = [k for k, a in fs.items() if a.dtype.kind in "biu"
                 and not np.array_equal(a, fp[k])]
    err = {k: _max_abs(a, fp[k], relative=k not in STEP_TOLERANCES)
           for k, a in fs.items() if a.dtype.kind == "f" and k != "gm.w"}
    w_ok = bool(np.allclose(fs["gm.w"], fp["gm.w"], rtol=1e-4, atol=1e-5,
                            equal_nan=True))
    rec = {"exact_fields_differing": differing,
           "max_abs_pose": err.pop("particles.pose"),
           "max_abs_log_w": err.pop("particles.log_w"),
           "max_abs_mean": err.pop("gm.mean"),
           "max_abs_w": _max_abs(fs["gm.w"], fp["gm.w"]), "w_ok": w_ok,
           "max_rel_other": max(err.values(), default=0.0)}
    rec["ok"] = (not differing and w_ok
                 and rec["max_rel_other"] <= OTHER_TOLERANCE
                 and all(rec[f"max_abs_{k.split('.')[-1]}"] <= t
                         for k, t in STEP_TOLERANCES.items()))
    return rec


def teacher_forced(filt, din, dt: float, warm: int, steps: int, mesh,
                   seed: int = 0, state=None) -> dict:
    """``warm`` free steps of the unsharded 2-D loop (``sim2d_common``'s
    inputs ``din``) from ``state`` (default: the filter's initial state),
    then ``steps`` steps each taken twice from the unsharded run's state
    with the same draws: unsharded, and sharded over ``mesh`` (the state
    cut to the rank's block, stepped, gathered).  Every rank runs the
    unsharded steps itself.  The draws come from a generator
    of ``seed`` alike on every rank (``[P, 3]`` motion noise and the
    resampling offset each step).  Returns the steps' records
    (:func:`compare_states`), ``did``, the sharded steps' collectives and
    bytes (the step's own, not the gather after it), their kernel
    launches, and the wall times of the sharded and the unsharded
    steps."""
    odo, z, z_mask, gt, lock, has_z = din
    dev = odo.device
    P = filt.cfg.n_particles
    gen = torch.Generator(device=dev).manual_seed(seed)
    kernels = _kernel_modules()

    def step(state, k, noise, u0, m):
        state = filt.predict(state, odo[k], dt, noise=noise, mesh=m)
        if lock[k]:
            state = dataclasses.replace(state, particles=dataclasses.replace(
                state.particles,
                pose=gt[k].expand_as(state.particles.pose).contiguous()))
        return filt.update(state, z[k], z_mask[k], u0=u0,
                           has_z=bool(has_z[k]), mesh=m)

    def timed(fn):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t0

    if state is None:
        state = filt.init_state(torch.zeros(3, device=dev))
    recs, did = [], []     # did: on the device until the end
    walls = {"sharded": 0.0, "unsharded": 0.0}
    launches = dict.fromkeys(kernels, 0)
    stats = {"collectives": 0, "bytes": 0}
    for k in range(warm + steps):
        noise = torch.randn((P, 3), generator=gen, device=dev)
        u0 = torch.rand((), generator=gen, device=dev)
        nxt, wall = timed(lambda: step(state, k, noise, u0, None))
        if k >= warm:
            walls["unsharded"] += wall
            before = {n: m.launches for n, m in kernels.items()}
            block = shard_state(state, mesh)
            sent = dict(mesh.stats)
            sh, wall = timed(lambda: step(block, k, mesh.block(noise), u0,
                                          mesh))
            walls["sharded"] += wall
            for n, m in kernels.items():
                launches[n] += m.launches - before[n]
            for n in stats:
                stats[n] += mesh.stats[n] - sent[n]
            recs.append(compare_states(_host(gather_state(sh, mesh)),
                                       _host(nxt)))
            did.append(nxt.n_updates == 0)
        state = nxt
    return {"records": recs, "did": torch.stack(did).cpu().numpy(),
            "launches": launches, "wall_s": walls, "collectives": stats}


def _rank_main(rank: int, world: int, coordinator: str, device_type: str,
               paths, workdir: str, result_path: str,
               backend: str | None, sync_check: bool,
               map_shards: int = 0, teacher: int | None = None,
               map_capacity: int | None = None) -> None:
    """One rank of :func:`run_sharded`: join the group (even alone, so the
    collectives go through the backend), drive each path sharded (with
    ``teacher``, teacher-forced after that many free steps; with
    ``map_capacity``, the replay's maps that wide), and (rank 0) pickle
    the results."""
    device = rank_device(rank, device_type)
    init_process_group(coordinator, world, rank, device, backend)
    try:
        results = {path: (drive_path(path, steps, device, workdir, True,
                                     sync_check, map_shards, map_capacity)
                          if teacher is None else
                          teacher_path(path, teacher, steps, device, workdir,
                                       map_shards, map_capacity))
                   for path, steps in paths}
        if rank == 0:
            with open(result_path, "wb") as f:
                pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


def teacher_path(path: str, warm: int, steps: int, device: torch.device,
                 workdir: str, map_shards: int = 0,
                 map_capacity: int | None = None) -> dict:
    """:func:`teacher_forced` of a 2-D path (:func:`setup`'s inputs) over
    the process group's mesh (:func:`sharded_mesh`)."""
    filt, drive = setup(path, warm + steps, device, workdir, map_capacity)
    mesh = sharded_mesh(filt, device, map_shards)
    out = teacher_forced(filt, drive.din, drive.dt, warm, steps, mesh)
    out.update(p_local=mesh.p_local, backend=dist.get_backend(mesh.group),
               particles=mesh.p_global, map_capacity=filt.cfg.map_capacity)
    return out


def spawn_ranks(target, ranks: int, workdir: str, timeout_s: float,
                args=()) -> None:
    """Run ``target(rank, ranks, coordinator, *args)`` in ``ranks``
    spawned processes, the group's ``coordinator`` a ``file://``
    rendezvous in ``workdir``; every process is killed after
    ``timeout_s``.  Raises when one fails or is killed."""
    ctx = multiprocessing.get_context("spawn")
    coordinator = "file://" + os.path.join(workdir, "rendezvous")
    procs = [ctx.Process(target=target,
                         args=(r, ranks, coordinator, *args))
             for r in range(ranks)]
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


def card_line() -> str:
    """The cards' names and power limits as nvidia-smi reports them, a
    line a card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


def rank_device(rank: int, device_type: str) -> torch.device:
    """Rank ``rank``'s device: card ``rank`` modulo the cards, or the CPU
    (one intra-op thread, as every rank shares the host)."""
    if device_type == "cpu":
        torch.set_num_threads(1)
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def run_sharded(paths, ranks: int, device_type: str, workdir: str,
                timeout_s: float = 600.0, backend: str | None = None,
                sync_check: bool = True, map_shards: int = 0,
                teacher: int | None = None,
                map_capacity: int | None = None) -> dict:
    """Drive ``paths`` (``(path, steps)`` pairs) sharded over ``ranks``
    spawned processes (:func:`spawn_ranks`), rank ``r`` on
    :func:`rank_device`, over ``backend`` (default: the device's, see
    :func:`init_process_group`).  ``map_shards``, ``teacher`` and
    ``map_capacity``: see :func:`_rank_main`.  Returns rank 0's
    :func:`drive_path` (or :func:`teacher_path`) results by path."""
    result_path = os.path.join(workdir, "sharded.pkl")
    spawn_ranks(_rank_main, ranks, workdir, timeout_s, (
        device_type, list(paths), workdir, result_path, backend, sync_check,
        map_shards, teacher, map_capacity))
    with open(result_path, "rb") as f:
        return pickle.load(f)


def _max_abs(a, b, relative: bool = False) -> float:
    """Largest |a - b| (with ``relative``, over max(1, |b|)), equal entries
    (infinities and NaNs too) counting 0 and a NaN against a number
    infinite."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    same = (a == b) | (np.isnan(a) & np.isnan(b))
    with np.errstate(invalid="ignore"):   # inf - inf where same
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
                  sync_check: bool = True, map_shards: int = 0,
                  teacher: int | None = None,
                  map_capacity: int | None = None) -> list[dict]:
    """Each path sharded over ``ranks`` processes (:func:`run_sharded`;
    with ``map_shards``, on the particles x map mesh) against its
    unsharded run in this process (on ``cuda:0`` or the CPU), one record
    each: ranks, mesh, backend, devices, steps, launches and collectives
    per step, bytes per step, steps/s sharded and unsharded, resamples,
    ancestors taken from another rank, and :func:`compare`'s checks.  With
    ``teacher`` the ranks run :func:`teacher_path` instead, and the record
    holds its steps' checks (:func:`teacher_record`).  ``map_capacity``:
    the replay's maps that wide (:func:`setup`)."""
    device = torch.device("cuda", 0) if device_type == "cuda" else (
        torch.device("cpu"))
    if map_shards and any(path not in MAP_PATHS for path, _ in paths):
        raise ValueError(f"a map mesh runs the paths {MAP_PATHS}")
    if device_type == "cuda":
        from rfs_slam_tpu_torch.ops.kernels import build

        # built once here; the ranks load the libraries
        build.load_all(sorted({k for path, _ in paths
                               for k in PATH_KERNELS[path]}))
    mesh_rec = {"ranks": ranks, "mesh": [ranks // map_shards, map_shards]
                if map_shards else [ranks]}
    with tempfile.TemporaryDirectory() as workdir:
        prepare(paths, workdir)
        sharded = run_sharded(paths, ranks, device_type, workdir, timeout_s,
                              backend, sync_check, map_shards, teacher,
                              map_capacity)
        records = []
        for path, steps in paths:
            sh = sharded[path]
            head = {"path": path, **mesh_rec, "backend": sh["backend"],
                    "devices": [str(device) if device_type == "cpu" else
                                f"cuda:{r % torch.cuda.device_count()}"
                                for r in range(ranks)], "steps": steps,
                    "p_local": sh["p_local"],
                    "map_capacity": sh["map_capacity"]}
            if teacher is not None:
                records.append({**head, **teacher_record(sh, path, teacher)})
                continue
            plain = drive_path(path, steps, device, workdir,
                               map_capacity=map_capacity)
            p_local = sh["p_local"]
            step = np.arange(sh["parent"].shape[1])
            moved = (sh["parent"] // p_local) != (step // p_local)[None, :]
            rec = {**head,
                   "particles": int(sh["parent"].shape[1]),
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


def teacher_record(sh: dict, path: str, warm: int) -> dict:
    """The summary of a :func:`teacher_path` result: steps held, the ones
    that failed :func:`compare_states`, the largest differences, the
    launches and collectives a sharded step, steps/s of the sharded and
    the unsharded steps."""
    recs, n = sh["records"], len(sh["records"])
    keys = ("max_abs_pose", "max_abs_log_w", "max_abs_mean", "max_abs_w",
            "max_rel_other")
    return {"teacher_forced_after": warm, "particles": sh["particles"],
            "failed_steps": [i for i, r in enumerate(recs) if not r["ok"]],
            "exact_fields_differing": sorted({f for r in recs
                                              for f in r[
                                                  "exact_fields_differing"]}),
            **{k: max(r[k] for r in recs) for k in keys},
            "launches_per_step": {k: sh["launches"][k] / n
                                  for k in PATH_KERNELS[path]},
            "collectives_per_step": sh["collectives"]["collectives"] / n,
            "collective_bytes_per_step": sh["collectives"]["bytes"] / n,
            "steps_per_s_sharded": n / sh["wall_s"]["sharded"],
            "steps_per_s_unsharded": n / sh["wall_s"]["unsharded"],
            "resamples": int(sh["did"].sum()),
            "ok": all(r["ok"] for r in recs)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, required=True)
    ap.add_argument("--path", action="append", choices=PATHS,
                    help="a path to run (repeatable; default: every one "
                         "the mesh runs)")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="one GPU per rank (NCCL), or the CPU (gloo)")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds before every rank is killed")
    ap.add_argument("--map-shards", type=int, default=0,
                    help="split each map over this many ranks (the replay "
                         "only): a ranks / B x B particles x map mesh")
    ap.add_argument("--teacher-forced", type=int, default=None,
                    metavar="WARM", help="step each step from the unsharded "
                    "state, after WARM free steps")
    ap.add_argument("--map-capacity", type=int, default=None,
                    help="the replay's map slots (default: the bench "
                         "filter's 128)")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < args.ranks:
            raise RuntimeError(
                f"{args.ranks} ranks need {args.ranks} GPUs, {have} found; "
                f"pass --device cpu to run the ranks on the CPU (gloo)")
        # the cards every number below ran on
        print(card_line(), flush=True)
    else:
        torch.set_num_threads(1)
    paths = [(p, args.steps) for p in (args.path or (
        MAP_PATHS if args.map_shards else PATHS))]
    ok = True
    for rec in compare_paths(paths, args.ranks, args.device, args.timeout,
                             map_shards=args.map_shards,
                             teacher=args.teacher_forced,
                             map_capacity=args.map_capacity):
        print(json.dumps(rec), flush=True)
        ok &= rec["ok"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
