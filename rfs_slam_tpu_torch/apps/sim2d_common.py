"""What the 2-D sim apps share, whatever their filter (RB-PHD in
``rbphdslam2dsim``, FastSLAM 1.0 / MH-FastSLAM in ``fastslam2dsim``, and
``batchsim``'s cells of either): the models wired from the sim config and
the XML, the per-step inputs, the device rule of the entry points, the step
loop, and the reference-format logs.

``run`` drives one whole run: predict -> ground-truth lock for the first
100 steps -> update -> best pose, one Python step per timestep with every
tensor on the generator's device; ``run_logged`` also keeps what the
reference's logs hold.  The filters share ``init_state``, ``predict`` and
``update``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rfs_slam_tpu_torch.io import logs, sim2d
from rfs_slam_tpu_torch.io.xmlconfig import XmlConfig
from rfs_slam_tpu_torch.models.measurement import RangeBearing
from rfs_slam_tpu_torch.models.motion import Odometry2D, StaticLandmark
from rfs_slam_tpu_torch.ops.ekf import InnovationGates
from rfs_slam_tpu_torch.parallel import mesh as mesh_lib

GT_LOCK_STEPS = 100
ERR_FROM_STEP = 150  # pose error is the median over steps >= 150


def sim_models(sim_cfg: sim2d.Sim2DConfig, device: torch.device,
               p_infl: float, z_infl: float):
    """The 2-D sim's motion, landmark and measurement models on ``device``
    (rbphdslam2dSim.cpp:444-470): process noise scaled by ``p_infl *
    dt^2``, landmark noise by ``dt^2``, measurement noise by ``z_infl``,
    each scaled in float64 and rounded once, as the JAX package does."""
    dt = sim_cfg.dt

    def diag(scale, *v):
        return torch.tensor(np.diag(v) * scale, dtype=torch.float32,
                            device=device)

    return (Odometry2D(Q=diag(p_infl * dt * dt, sim_cfg.vardx,
                              sim_cfg.vardy, sim_cfg.vardz)),
            StaticLandmark(Q=diag(dt * dt, sim_cfg.varlmx, sim_cfg.varlmy)),
            RangeBearing(R=diag(z_infl, sim_cfg.varzr, sim_cfg.varzb),
                         pd_const=sim_cfg.pd, clutter=sim_cfg.clutter,
                         r_max=sim_cfg.range_max, r_min=sim_cfg.range_min,
                         r_buf=sim_cfg.range_buffer))


def xml_models(cfg: XmlConfig, sim_cfg: sim2d.Sim2DConfig,
               device: torch.device):
    """:func:`sim_models` and the KF innovation gates, from a
    reference-format XML (the 2-D apps' keys and defaults)."""
    f = "filter.update.KalmanFilter.innovationThreshold."
    return (*sim_models(
        sim_cfg, device,
        cfg.get("filter.predict.processNoiseInflationFactor", 1.0),
        cfg.get("filter.update.measurementNoiseInflationFactor", 1.0)),
        InnovationGates.range_bearing(range_t=cfg.get(f + "range", -1.0),
                                      bearing_t=cfg.get(f + "bearing", -1.0)))


def sim_inputs(data: sim2d.Sim2DData, steps: int | None = None,
               z_capacity: int | None = None):
    """Per-step inputs (odo, z, z_mask, gt, lock) for timesteps 1..T-1 (of
    the first ``steps``), the measurement axis padded to ``z_capacity``."""
    n = data.gt_pose.shape[0] if steps is None else steps
    k = np.arange(1, n)
    z, z_mask = data.z[1:n], data.z_mask[1:n]
    pad = (z_capacity or 0) - z.shape[1]
    if pad > 0:
        z = np.pad(z, ((0, 0), (0, pad), (0, 0)))
        z_mask = np.pad(z_mask, ((0, 0), (0, pad)))
    return (data.odometry[1:n], z, z_mask, data.gt_pose[1:n],
            k <= GT_LOCK_STEPS)


def device_for(name: str | None = None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU.  Raises where there is no card."""
    dev = torch.device(name or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu (or "
                           "device=torch.device('cpu')) to run on the CPU")
    return dev


def device_inputs(inputs, dev: torch.device):
    """The per-step inputs ``(odo, z, z_mask, gt, lock)`` as device tensors
    ``(odo, z, z_mask, gt)`` and host arrays ``(lock, has_z)``."""
    odo, z, z_mask, gt, lock = inputs

    def put(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    return (put(odo), put(z), put(z_mask, torch.bool), put(gt),
            np.asarray(lock), np.asarray(z_mask).any(axis=1))


def steps(filt, dinputs, gen: torch.Generator, dt: float, on_step,
          mesh=None):
    """The step loop over :func:`device_inputs`: predict, the ground-truth
    lock, update (empty updates skipped from the host flags), then
    ``on_step(k, state)``.  Nothing here reads from the device.  Returns
    the final state.

    Under ``mesh`` (``parallel/mesh.py``) the state is this rank's block of
    the particle axis (and, under a particles x map mesh, of each map's
    slots): every rank draws the whole ``[P, 3]`` motion noise from
    ``gen`` (seeded alike on every rank) and keeps its particles' block, so
    the draws are the unsharded run's, and the returned state is the
    block.
    """
    odo, z, z_mask, gt, lock, has_z = dinputs
    state = filt.init_state(torch.zeros(3, device=odo.device))
    if mesh is not None:
        state = mesh_lib.shard_state(state, mesh)
    for k in range(len(lock)):
        noise = None if mesh is None else mesh.randn_block(gen, 3)
        state = filt.predict(state, odo[k], dt, gen=gen, noise=noise,
                             mesh=mesh)
        if lock[k]:
            pose = gt[k].expand_as(state.particles.pose).contiguous()
            state = dataclasses.replace(
                state, particles=dataclasses.replace(state.particles,
                                                     pose=pose))
        state = filt.update(state, z[k], z_mask[k], gen=gen,
                            has_z=bool(has_z[k]), mesh=mesh)
        on_step(k, state)
    return state


def run(filt, inputs, gen: torch.Generator, dt: float, mesh=None):
    """One whole run on ``gen``'s device.  Returns ``(final state, best
    particle pose per step [n, 3] numpy)``: each step's weights and poses
    are logged on the device and the best particle is taken once after the
    loop, so the only device-to-host copy is the best poses at the end.
    Under ``mesh`` the state is this rank's block, and the logs are
    gathered over the ranks first, so the best particle is the argmax of
    the global weights."""
    din = device_inputs(inputs, gen.device)
    n = len(din[-1])
    P = (getattr(filt, "p_cap", filt.cfg.n_particles) if mesh is None
         else mesh.p_local)
    lw = torch.empty((n, P), device=gen.device)
    poses = torch.empty((n, P, 3), device=gen.device)

    def log(k, state):
        lw[k] = state.particles.log_w
        poses[k] = state.particles.pose

    state = steps(filt, din, gen, dt, log, mesh)
    if mesh is not None:
        lw, poses = mesh.all_gather(lw, 1), mesh.all_gather(poses, 1)
    best = poses[torch.arange(n, device=gen.device), lw.argmax(dim=1)]
    return state, best.cpu().numpy()


def run_logged(filt, inputs, gen: torch.Generator, dt: float):
    """:func:`run` keeping what the reference's logs hold, per step: every
    particle's pose and weight, the best particle, and its map.  Returns
    ``(final state, outs)``, ``outs`` numpy arrays: ``pose [n, P, 3]``,
    ``w [n, P]``, ``best [n]``, ``mean [n, M, 2]``, ``cov [n, M, 3]``
    (packed), ``gm_w [n, M]``, ``alive [n, M]``."""
    din = device_inputs(inputs, gen.device)
    out, record = log_recorder(filt, len(din[-1]), gen.device)
    state = steps(filt, din, gen, dt, record)
    return state, {k: v.cpu().numpy() for k, v in out.items()}


def log_recorder(filt, n: int, dev):
    """``(outs, record)``: device buffers for :func:`run_logged`'s outputs
    over ``n`` steps and the ``on_step`` callback that fills them (it reads
    nothing back)."""
    P = getattr(filt, "p_cap", filt.cfg.n_particles)
    M = filt.cfg.map_capacity
    out = dict(pose=torch.empty((n, P, 3), device=dev),
               w=torch.empty((n, P), device=dev),
               best=torch.empty((n,), dtype=torch.long, device=dev),
               mean=torch.empty((n, M, 2), device=dev),
               cov=torch.empty((n, M, 3), device=dev),
               gm_w=torch.empty((n, M), device=dev),
               alive=torch.empty((n, M), dtype=torch.bool, device=dev))

    def record(k, state):
        w = torch.exp(state.particles.log_w)
        b = torch.argmax(w).view(1)
        gm = state.gm
        out["pose"][k] = state.particles.pose
        out["w"][k] = w
        out["best"][k] = b[0]
        out["mean"][k] = gm.mean.index_select(1, b)[:, 0].T
        out["cov"][k] = gm.cov.index_select(1, b)[:, 0].T
        out["gm_w"][k] = gm.w.index_select(0, b)[0]
        out["alive"][k] = gm.alive.index_select(0, b)[0]

    return out, record


def write_logs(logdir, cfg_path, data, dt, outs):
    """The reference-format logs of a 2-D sim run (io/logs.py) and the
    median best-particle position error over steps >= 150 (or the second
    half of a shorter run)."""
    n = len(outs["best"])
    times = np.arange(1, n + 1) * dt
    logs.write_sim_data(logdir, data, dt=dt, cfg_src_path=cfg_path)
    logs.write_particle_poses(logdir, times, outs["pose"], outs["w"])
    logs.write_landmark_estimates(logdir, times, outs["best"], outs["mean"],
                                  outs["cov"], outs["gm_w"], outs["alive"])
    err = np.linalg.norm(outs["pose"][np.arange(n), outs["best"], :2]
                         - data.gt_pose[1:n + 1, :2], axis=1)
    return float(np.median(err[min(ERR_FROM_STEP, (n + 1) // 2):]))


def median_pose_error(best: np.ndarray, gt: np.ndarray) -> float:
    """Median best-particle position error over steps >= 150 (``best`` and
    ``gt`` aligned per step)."""
    err = np.linalg.norm(best[:, :2] - gt[:, :2], axis=1)
    return float(np.median(err[ERR_FROM_STEP:]))


def seed_errors(filt, inputs, gt: np.ndarray, dt: float, seeds,
                device: torch.device) -> list[float]:
    """:func:`median_pose_error` of one :func:`run` per generator seed on
    the same inputs: the spread of the process over its draws."""
    return [median_pose_error(run(filt, inputs, torch.Generator(
        device=device).manual_seed(seed), dt)[1], gt) for seed in seeds]
