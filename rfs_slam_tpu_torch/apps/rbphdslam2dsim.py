"""RB-PHD SLAM on the 2-D range-bearing simulation: the bench workload.

``build`` wires the configuration of the JAX package's ``bench.py``
(P=200 particles, map capacity 128, measurement capacity 40, the
rbphdslam2dSim.xml defaults); ``run`` drives one whole run: predict ->
ground-truth lock for the first 100 steps -> update -> best pose, one
Python step per timestep with every tensor on the filter's device.

The reference XML/``.dat`` command line waits for ROADMAP.md Queue 1 #10.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from rfs_slam_tpu_torch.filters.rbphd import RBPHDConfig, RBPHDFilter
from rfs_slam_tpu_torch.io import sim2d
from rfs_slam_tpu_torch.models.measurement import RangeBearing
from rfs_slam_tpu_torch.models.motion import Odometry2D, StaticLandmark
from rfs_slam_tpu_torch.ops.ekf import InnovationGates

N_PARTICLES = 200
T = 3000
Z_CAPACITY = 40
MAP_CAPACITY = 128
GT_LOCK_STEPS = 100
ERR_FROM_STEP = 150  # pose error is the median over steps >= 150


def build_filter(sim_cfg: sim2d.Sim2DConfig, device: torch.device,
                 n_particles: int = N_PARTICLES) -> RBPHDFilter:
    """The filter of bench.py:52-81 on ``device``."""
    dt = sim_cfg.dt

    def diag(scale, *v):
        # scaled in float64, then rounded once, as the JAX package does
        return torch.tensor(np.diag(v) * scale, dtype=torch.float32,
                            device=device)

    motion = Odometry2D(Q=diag(1.5 * dt * dt, sim_cfg.vardx, sim_cfg.vardy,
                               sim_cfg.vardz))
    lmk = StaticLandmark(Q=diag(dt * dt, sim_cfg.varlmx, sim_cfg.varlmy))
    meas = RangeBearing(
        R=diag(10.0, sim_cfg.varzr, sim_cfg.varzb),
        pd_const=sim_cfg.pd, clutter=sim_cfg.clutter,
        r_max=sim_cfg.range_max, r_min=sim_cfg.range_min,
        r_buf=sim_cfg.range_buffer,
    )
    gates = InnovationGates.range_bearing(range_t=1.0, bearing_t=0.2)
    cfg = RBPHDConfig(
        n_particles=n_particles, map_capacity=MAP_CAPACITY,
        z_capacity=Z_CAPACITY, new_capacity=48, new_per_z=8,
        birth_capacity=16, eval_capacity=15, z_dp_max=10,
        birth_gaussian_weight=0.01, new_gaussian_md_threshold=3.0,
        eval_pt_min_weight=0.75, weighting_md_threshold=3.0,
        merge_threshold=0.5, merge_inflation=1.5, prune_threshold=0.01,
        min_updates_before_resample=2, ess_threshold=100.0,
    )
    return RBPHDFilter(motion, lmk, meas, gates, cfg)


def sim_inputs(data: sim2d.Sim2DData, steps: int | None = None):
    """Per-step inputs (odo, z, z_mask, gt, lock) for timesteps 1..T-1."""
    n = data.gt_pose.shape[0] if steps is None else steps
    k = np.arange(1, n)
    return (data.odometry[1:n], data.z[1:n], data.z_mask[1:n],
            data.gt_pose[1:n], k <= GT_LOCK_STEPS)


def load_bl_dump(path: str, steps: int = T, z_capacity: int = Z_CAPACITY):
    """The committed C++ baseline dump (``native/bl_dump``: the same
    simulated data the reference's double-precision baseline ran) as
    ``(gt_pose [steps, 3], inputs)``."""
    go = np.loadtxt(os.path.join(path, "gt_odo.txt"))[:steps]
    gt, odo = go[:, :3], go[:, 3:]
    z = np.zeros((steps, z_capacity, 2), np.float32)
    z_mask = np.zeros((steps, z_capacity), bool)
    counts = np.zeros(steps, np.int32)
    for k, r, b in np.loadtxt(os.path.join(path, "z.txt")):
        k = int(k)
        if k < steps and counts[k] < z_capacity:
            z[k, counts[k]] = (r, b)
            z_mask[k, counts[k]] = True
            counts[k] += 1
    lock = np.arange(1, steps) <= GT_LOCK_STEPS
    return gt, (odo[1:], z[1:], z_mask[1:], gt[1:], lock)


def run(filt: RBPHDFilter, inputs, gen: torch.Generator, dt: float):
    """One whole run on ``gen``'s device.  Returns ``(final state, best
    particle pose per step [n, 3] numpy)``; the only device-to-host copy is
    the pose log at the end."""
    dev = gen.device
    odo, z, z_mask, gt, lock = inputs
    has_z = np.asarray(z_mask).any(axis=1)

    def put(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    odo_d, z_d, gt_d = put(odo), put(z), put(gt)
    zm_d = put(z_mask, torch.bool)
    P = filt.cfg.n_particles
    state = filt.init_state(torch.zeros(3, device=dev))
    best = torch.empty((len(odo), 3), device=dev)
    for k in range(len(odo)):
        state = filt.predict(state, odo_d[k], dt, gen=gen)
        if lock[k]:
            pose = gt_d[k].expand(P, 3).contiguous()
            state = dataclasses.replace(
                state, particles=dataclasses.replace(state.particles,
                                                     pose=pose))
        state = filt.update(state, z_d[k], zm_d[k], gen=gen,
                            has_z=bool(has_z[k]))
        best[k] = state.particles.pose[torch.argmax(state.particles.log_w)]
    return state, best.cpu().numpy()


def median_pose_error(best: np.ndarray, gt: np.ndarray) -> float:
    """Median best-particle position error over steps >= 150 (``best`` and
    ``gt`` aligned per step)."""
    err = np.linalg.norm(best[:, :2] - gt[:, :2], axis=1)
    return float(np.median(err[ERR_FROM_STEP:]))
