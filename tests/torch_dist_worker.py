"""One rank of the port's sharded CPU tests (tests/test_torch_mesh.py): the
counterpart of ``dist_smoke_worker.py`` for ``rfs_slam_tpu_torch.parallel``.

Run as: python tests/torch_dist_worker.py <rank> <world> <dir>

Joins a gloo group through a ``file://`` rendezvous in ``dir``, reads the
scenarios of ``dir/inputs.pt`` (written by the test), runs each sharded
over the group, and (rank 0) saves the gathered results to
``dir/out_<world>.pt``.  Imports no JAX; the scenarios' filters and
inputs are built by :func:`drives`, which the test also calls for the
unsharded runs.
"""

import os
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
torch.set_num_threads(1)


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


def main(rank: int, world: int, d: str) -> None:
    spec = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
    mesh_lib.init_distributed("file://" + os.path.join(d, f"rdv_{world}"),
                              world, rank, device=CPU)
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
    if rank == 0:
        torch.save(out, os.path.join(d, f"out_{world}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
