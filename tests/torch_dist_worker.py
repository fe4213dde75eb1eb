"""One rank of the port's sharded CPU tests (``tests/test_torch_mesh.py``,
``test_torch_mh_mesh.py``, ``test_torch_map_mesh.py``): the counterpart of
``dist_smoke_worker.py`` for ``rfs_slam_tpu_torch.parallel``.

Run as: python tests/torch_dist_worker.py <rank> <world> <dir> [suite]

Joins a gloo group through a ``file://`` rendezvous in ``dir``, reads the
scenarios of ``dir/inputs.pt`` (written by the test), runs the suite's
scenarios sharded over the group, and (rank 0) saves the gathered results
to ``dir/out_<world>.pt``.  Suites: ``mesh`` (the particle mesh, the
default), ``mh`` and ``map`` (:data:`SUITES`), the last two defined in
their test modules' helpers below.  Imports no JAX; the scenarios' filters
and inputs are built by :func:`drives`, which the test also calls for the
unsharded runs.  :func:`start` and :func:`finish` run the ranks of several
worlds at once from a test.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import torch

from rfs_slam_tpu_torch.apps import fastslam2dsim as fs_app
from rfs_slam_tpu_torch.apps import rbphdslam_victoriapark as vp_app
from rfs_slam_tpu_torch.apps import sim2d_common as loop
from rfs_slam_tpu_torch.io import sim2d
from rfs_slam_tpu_torch.io import victoria_park as vp_io
from rfs_slam_tpu_torch.io.xmlconfig import XmlConfig
from rfs_slam_tpu_torch.ops import resample
from rfs_slam_tpu_torch.parallel import dryrun
from rfs_slam_tpu_torch.parallel import mesh as mesh_lib

CPU = torch.device("cpu")
DT = 0.1
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT_S = 240
torch.set_num_threads(1)


def start(d, worlds, suite: str = "mesh"):
    """Every rank of each world in ``worlds``, all at once, as processes
    of this file on the scenarios in ``d``; finish them with
    :func:`finish`."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return [(world, subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(rank), str(world),
         str(d), suite], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True))
        for world in worlds for rank in range(world)]


def finish(d, procs, timeout_s: float = WORKER_TIMEOUT_S):
    """Wait for :func:`start`'s processes (each killed after
    ``timeout_s``) and return rank 0's results by world size."""
    failed = []
    try:
        for world, p in procs:
            _, err = p.communicate(timeout=timeout_s)
            if p.returncode:
                failed.append(f"world {world}: {err[-3000:]}")
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not failed, failed
    return {w: torch.load(os.path.join(d, f"out_{w}.pt"), weights_only=False)
            for w in sorted({w for w, _ in procs})}


def drives(spec):
    """``{name: (filter, drive, steps)}`` of the multi-step scenarios
    (``drive`` as ``dryrun.setup``'s): the 60-step run of the graft filter,
    FastSLAM 1.0 on a short simulation, and Victoria Park RB-PHD (D=3) on
    a short synthetic stream."""
    out = {}
    m = spec["multistep"]
    filt = m["filt"]
    out["multistep"] = (filt, dryrun.sim2d_drive(
        filt, loop.device_inputs(m["inputs"], CPU), DT),
        len(m["inputs"][0]))

    f = spec["fastslam"]
    sim_cfg = sim2d.Sim2DConfig(**f["sim"])
    data = sim2d.generate(sim_cfg, traj_seed=1, noise_seed=1,
                          z_capacity=f["zc"])
    fs = fs_app.build_filter_from_xml(XmlConfig(f["xml"]), sim_cfg,
                                      z_capacity=f["zc"],
                                      n_particles=f["particles"], device=CPU)
    odo, z, zm, gt, lock = loop.sim_inputs(data)
    out["fastslam"] = (fs, dryrun.sim2d_drive(fs, loop.device_inputs(
        (odo, z, zm, gt, np.zeros_like(lock)), CPU), sim_cfg.dt), len(odo))

    v = spec["vp"]
    vfilt, icov, ack = vp_app.build(XmlConfig(v["cfg"]),
                                    map_capacity=v["map_capacity"],
                                    n_particles=v["particles"], device=CPU)
    frames = vp_io.load(v["dir"], z_capacity=vp_app.Z_CAPACITY,
                        ackerman=ack)
    out["vp"] = (vfilt, dryrun.vp_drive(vfilt, vp_app.step_frame, frames,
                                          icov), len(frames.t))
    return out


def one_step(spec):
    """The graft filter's predict + update on the example state with JAX's
    draws, sharded: the gathered state."""
    s = spec["one_step"]
    filt = s["filt"]
    mesh = mesh_lib.make_mesh(filt.cfg.n_particles, CPU)
    state = mesh_lib.shard_state(s["state"], mesh)
    state = filt.predict(state, s["odo"], DT, noise=mesh.block(s["noise"]))
    state = filt.update(state, s["z"], s["z_mask"], u0=s["u0"], mesh=mesh)
    return mesh_lib.gather_state(state, mesh)


def smoke(n_particles: int = 8):
    """For w_i proportional to i: the global ESS and the total mass of the
    globally normalised weights."""
    mesh = mesh_lib.make_mesh(n_particles, CPU)
    log_w = mesh.block(torch.log(torch.arange(1, n_particles + 1,
                                              dtype=torch.float32)))
    ess = resample.effective_count(mesh.all_gather(log_w))
    mass = torch.exp(resample.normalize_log_weights(
        mesh.all_gather(log_w))).sum()
    return {"ess": float(ess), "mass": float(mass)}


def mesh_suite(spec) -> dict:
    """The particle mesh's scenarios (``tests/test_torch_mesh.py``)."""
    out = {"smoke": smoke(), "one_step": one_step(spec)}
    try:
        mesh_lib.make_mesh(9, CPU)
        out["uneven_refused"] = False
    except ValueError:
        out["uneven_refused"] = True
    for name, (filt, drive, steps) in drives(spec).items():
        out[name] = dryrun.drive_logged(filt, drive, steps, CPU,
                                          sharded=True)
    m = spec["multistep"]
    out["best"] = loop.run(m["filt"], m["inputs"],
                           torch.Generator().manual_seed(0), DT,
                           mesh_lib.make_mesh(m["filt"].cfg.n_particles,
                                              CPU))[1]
    return out


class overflow_log:
    """Within the block, every ``murty_gated`` call of the FastSLAM filter
    also returns its overflow count, appended to the list this yields (the
    counter the filter does not keep)."""

    def __enter__(self):
        from rfs_slam_tpu_torch.filters import fastslam as fs_mod

        self.mod, self.inner, self.log = fs_mod, fs_mod.murty_gated, []

        def gated(*args, **kw):
            das, scores, valid, over = self.inner(*args, return_overflow=True,
                                                  **kw)
            self.log.append(over)
            return das, scores, valid
        fs_mod.murty_gated = gated
        return self.log

    def __exit__(self, *exc):
        self.mod.murty_gated = self.inner


def mh_run(run, sharded: bool = False) -> dict:
    """``dryrun.drive_logged`` of an MH-FastSLAM scenario (``filt``,
    ``inputs`` of ``sim2d_common.sim_inputs``' form, ``dt``), with each
    update's lane-budget overflow (``overflow [S]``)."""
    filt = run["filt"]
    drive = dryrun.sim2d_drive(filt, loop.device_inputs(run["inputs"], CPU),
                               run["dt"])
    with overflow_log() as log:
        out = dryrun.drive_logged(filt, drive, len(run["inputs"][0]), CPU,
                                  sharded=sharded)
    out["overflow"] = torch.stack(log).numpy()
    return out


def lane_budget(case, sharded: bool = False) -> dict:
    """``murty_gated`` with its overflow on ``case``'s tables (``[P, n,
    n]``), over the ranks with ``sharded``: the outputs of every lane."""
    from rfs_slam_tpu_torch.ops.assignment import murty_gated

    tables, rows = case["tables"], case["real_rows"]
    mesh = None
    if sharded:
        mesh = mesh_lib.make_mesh(tables.shape[0], CPU)
        tables, rows = mesh.block(tables), mesh.block(rows)
    das, scores, valid, over = murty_gated(
        tables, case["k"], rows, real_cols=case["real_cols"],
        child_cap=case["child_cap"], prune_window=case["window"],
        budget=case["budget"], return_overflow=True, mesh=mesh)
    if mesh is not None:
        das, scores, valid = (mesh.all_gather(x) for x in (das, scores,
                                                           valid))
    return {"das": das.numpy(), "scores": scores.numpy(),
            "valid": valid.numpy(), "overflow": int(over)}


def mh_step(s, sharded: bool = False):
    """One MH-FastSLAM predict + update of ``s`` (``filt``, ``state``, the
    draws ``noise`` and ``u0``, ``odo``, ``z``, ``z_mask``, the ground-truth
    lock ``lock`` to ``gt``), over the ranks with ``sharded``: the whole
    state after it."""
    filt, state, noise = s["filt"], s["state"], s["noise"]
    mesh = None
    if sharded:
        mesh = mesh_lib.make_mesh(filt.p_cap, CPU)
        state, noise = mesh_lib.shard_state(state, mesh), mesh.block(noise)
    state = filt.predict(state, s["odo"], DT, noise=noise)
    if s["lock"]:
        state = dataclasses.replace(state, particles=dataclasses.replace(
            state.particles, pose=s["gt"].expand_as(
                state.particles.pose).contiguous()))
    state = filt.update(state, s["z"], s["z_mask"], u0=s["u0"], mesh=mesh)
    return state if mesh is None else mesh_lib.gather_state(state, mesh)


def mh_suite(spec) -> dict:
    """MH-FastSLAM under the particle mesh (``tests/test_torch_mh_mesh.py``):
    both forms over many steps, the lane budget, one step."""
    out = {name: mh_run(run, sharded=True)
           for name, run in spec["runs"].items()}
    out["lane_budget"] = lane_budget(spec["lane_budget"], sharded=True)
    out["step"] = {name: mh_step(s, sharded=True)
                   for name, s in spec["step"].items()}
    return out


def map_shape(world: int) -> tuple:
    """The particles x map mesh of a world: 1 x 2 on 2 ranks, 2 x 2 on 4."""
    return (world // 2, 2)


def map_suite(spec) -> dict:
    """RB-PHD under the particles x map mesh (``tests/
    test_torch_map_mesh.py``): the graft step with JAX's draws, the
    teacher-forced steps (on 4 ranks), the uneven splits refused."""
    world = torch.distributed.get_world_size()
    A, B = map_shape(world)
    s = spec["one_step"]
    filt = s["filt"]
    P, M = filt.cfg.n_particles, filt.cfg.map_capacity
    mesh = mesh_lib.make_mesh_2d(A, B, P, M, CPU)
    state = mesh_lib.shard_state(s["state"], mesh)
    state = filt.predict(state, s["odo"], DT, noise=mesh.block(s["noise"]),
                         mesh=mesh)
    state = filt.update(state, s["z"], s["z_mask"], u0=s["u0"], mesh=mesh)
    out = {"stats": dict(mesh.stats), "m_local": mesh.m_local,
           "one_step": mesh_lib.gather_state(state, mesh)}
    if world == 4:
        t = spec["teacher"]
        out["teacher"] = dryrun.teacher_forced(
            t["filt"], loop.device_inputs(t["inputs"], CPU), DT, t["warm"],
            t["steps"], mesh, state=t["state"])
    refused = {}
    for name, (p, m, a, b) in {"particles": (P + 1, M, world, 1),
                               "slots": (P, M + 1, 1, world),
                               "ranks": (P, M, 1, 1)}.items():
        try:
            mesh_lib.make_mesh_2d(a, b, p, m, CPU)
            refused[name] = False
        except ValueError:
            refused[name] = True
    out["refused"] = refused
    return out


def main(rank: int, world: int, d: str, suite: str = "mesh") -> None:
    spec = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
    mesh_lib.init_distributed("file://" + os.path.join(d, f"rdv_{world}"),
                              world, rank, device=CPU)
    out = SUITES[suite](spec)
    if rank == 0:
        torch.save(out, os.path.join(d, f"out_{world}.pt"))
    torch.distributed.destroy_process_group()


SUITES = {"mesh": mesh_suite, "mh": mh_suite, "map": map_suite}

if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], *sys.argv[4:5])
