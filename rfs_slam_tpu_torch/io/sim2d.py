"""2-D range-bearing SLAM simulation data generator.

Host-side NumPy reimplementation of the data generation in the reference
simulator apps (reference: rbphdslam2dSim.cpp:150-366 — piecewise-constant-
velocity trajectory, odometry sampling, landmark placement via the inverse
measurement model, detections with Pd thinning, Poisson clutter).  The RNG is
``numpy.random.default_rng`` seeded like the reference's ``--trajectory`` /
``--seed`` flags; parity with the reference's drand48 stream is
distributional, not bitwise.

Measurements are returned pre-bucketed per timestep into a fixed-capacity
``[T, Zmax, 2]`` tensor + validity mask so that the device-side filter loop
is fixed-shape.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Sim2DConfig:
    """Mirrors the <config> XML of the 2-D sims (cfg/rbphdslam2dSim.xml)."""

    timesteps: int = 3000
    dt: float = 0.1
    n_segments: int = 20
    max_dx: float = 0.3
    max_dy: float = 0.0
    max_dz: float = 0.5
    min_dx: float = 0.1
    vardx: float = 0.002
    vardy: float = 0.002
    vardz: float = 0.002
    n_landmarks: int = 50
    varlmx: float = 0.0002
    varlmy: float = 0.0002
    range_max: float = 2.5
    range_min: float = 0.5
    range_buffer: float = 0.05
    pd: float = 0.99
    clutter: float = 0.0001
    varzr: float = 0.0005
    varzb: float = 0.00005


@dataclasses.dataclass
class Sim2DData:
    gt_pose: np.ndarray        # [T, 3]
    gt_input: np.ndarray       # [T, 3]  groundtruth displacement input
    odometry: np.ndarray       # [T, 3]  noisy odometry
    dr_pose: np.ndarray        # [T, 3]  dead-reckoned path
    landmarks: np.ndarray      # [L, 2]
    lmk_first_obs: np.ndarray  # [L]  first-observable time, -1 if never
    z: np.ndarray              # [T, Zmax, 2]
    z_mask: np.ndarray         # [T, Zmax] bool
    z_count: np.ndarray        # [T]


def _step_odometry2d(pose, u):
    c, s = np.cos(pose[2]), np.sin(pose[2])
    x = pose[0] + c * u[0] - s * u[1]
    y = pose[1] + s * u[0] + c * u[1]
    th = pose[2] + u[2]
    th = (th + np.pi) % (2 * np.pi) - np.pi
    return np.array([x, y, th])


def generate(cfg: Sim2DConfig, traj_seed: int = 0, noise_seed: int = 1,
             z_capacity: int | None = None) -> Sim2DData:
    T = cfg.timesteps
    dt = cfg.dt
    rng_traj = np.random.default_rng(traj_seed)
    rng = np.random.default_rng(noise_seed + (1 << 16))

    # ---- groundtruth trajectory (rbphdslam2dSim.cpp:150-205)
    gt_input = np.zeros((T, 3))
    gt_pose = np.zeros((T, 3))
    seg = 0
    u = np.zeros(3)
    for k in range(1, T):
        if k <= 50:
            u = np.zeros(3)
        elif k >= T / cfg.n_segments * seg:
            seg += 1
            dx = rng_traj.uniform() * cfg.max_dx * dt
            while dx < cfg.min_dx * dt:
                dx = rng_traj.uniform() * cfg.max_dx * dt
            dy = (rng_traj.uniform() * 2 * cfg.max_dy - cfg.max_dy) * dt
            dz = (rng_traj.uniform() * 2 * cfg.max_dz - cfg.max_dz) * dt
            u = np.array([dx, dy, dz])
        gt_input[k] = u
        gt_pose[k] = _step_odometry2d(gt_pose[k - 1], u)

    # ---- noisy odometry + dead reckoning (rbphdslam2dSim.cpp:208-244)
    Q = np.diag([cfg.vardx, cfg.vardy, cfg.vardz]) * dt * dt
    Lq = np.linalg.cholesky(Q)
    odometry = np.zeros((T, 3))
    dr_pose = np.zeros((T, 3))
    for k in range(1, T):
        odometry[k] = gt_input[k] + Lq @ rng.standard_normal(3)
        dr_pose[k] = _step_odometry2d(dr_pose[k - 1], odometry[k])

    # ---- landmarks via inverse measurement model (rbphdslam2dSim.cpp:247-280)
    landmarks = []
    n_created = 0
    for k in range(1, T):
        if k >= T / cfg.n_landmarks * n_created and n_created < cfg.n_landmarks:
            r = rng_traj.uniform() * cfg.range_max
            b = rng_traj.uniform() * 2 * np.pi
            x, y, th = gt_pose[k]
            landmarks.append([x + r * np.cos(th + b), y + r * np.sin(th + b)])
            n_created += 1
    landmarks = np.asarray(landmarks)
    L = len(landmarks)

    # ---- measurements (rbphdslam2dSim.cpp:283-366)
    mean_clutter = cfg.clutter * 2 * np.pi * (cfg.range_max - cfg.range_min)
    sr, sb = np.sqrt(cfg.varzr), np.sqrt(cfg.varzb)
    first_obs = np.full(L, -1.0)
    per_step: list[list[np.ndarray]] = [[] for _ in range(T)]
    for k in range(1, T):
        x, y, th = gt_pose[k]
        dxy = landmarks - np.array([x, y])
        true_r = np.hypot(dxy[:, 0], dxy[:, 1])
        true_b = np.arctan2(dxy[:, 1], dxy[:, 0]) - th
        success = (true_r >= cfg.range_min) & (true_r <= cfg.range_max)
        zr = true_r + sr * rng.standard_normal(L)
        zb = true_b + sb * rng.standard_normal(L)
        zb = (zb + np.pi) % (2 * np.pi) - np.pi
        keep = (
            success & (zr <= cfg.range_max) & (zr >= cfg.range_min)
            & (rng.uniform(size=L) <= cfg.pd)
        )
        for m in np.nonzero(keep)[0]:
            per_step[k].append(np.array([zr[m], zb[m]]))
        newly = success & (first_obs < 0)
        first_obs[newly] = k * dt
        # Poisson clutter
        n_clutter = rng.poisson(mean_clutter)
        for _ in range(n_clutter):
            r = rng.uniform() * cfg.range_max
            while r < cfg.range_min:
                r = rng.uniform() * cfg.range_max
            b = rng.uniform() * 2 * np.pi - np.pi
            per_step[k].append(np.array([r, b]))

    counts = np.array([len(s) for s in per_step])
    zmax = int(z_capacity or max(int(counts.max()), 1))
    if counts.max() > zmax:
        raise ValueError(
            f"z_capacity {zmax} < max measurements per step {counts.max()}"
        )
    z = np.zeros((T, zmax, 2))
    z_mask = np.zeros((T, zmax), bool)
    for k in range(T):
        for j, zz in enumerate(per_step[k]):
            z[k, j] = zz
            z_mask[k, j] = True

    return Sim2DData(
        gt_pose=gt_pose, gt_input=gt_input, odometry=odometry, dr_pose=dr_pose,
        landmarks=landmarks, lmk_first_obs=first_obs,
        z=z, z_mask=z_mask, z_count=counts,
    )
