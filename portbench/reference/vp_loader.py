"""Victoria Park dataset loader + fixed-shape frame builder, frozen from the
port's ``io/victoria_park.py`` (numpy's text parser in place of the native
one): the reference reads the stream's files itself.

Reference: rbphdslam_VictoriaPark.cpp:199-324 reads five files (sensor
manager, inputs, detections, raw lidar, GPS) and processes them as an event
stream — Input messages trigger predicts with the held previous input,
Lidar messages trigger a predict-to-scan-time plus an update
(rbphdslam_VictoriaPark.cpp:471-628).

The event stream is re-bucketed into fixed-shape "lidar frames": frame j
carries up to ``K_PRED`` predict sub-steps (dt, held input, noise flag)
followed by the scan's measurement set.

The repository's copy of the dataset ships without the raw-scan file
(LASER.txt); when absent, frames carry no scans and the measurement model
falls back to geometry-only Pd and sector-area clutter intensity.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


def _loadtxt(path):
    return np.loadtxt(path, ndmin=2)


@dataclasses.dataclass
class VPFrames:
    """Fixed-shape event stream: F lidar frames."""

    t: np.ndarray            # [F] scan times
    pred_dt: np.ndarray      # [F, K] predict sub-step dt (0 padded)
    pred_u: np.ndarray       # [F, K, 2] held input (vel, scaled steer)
    pred_noise: np.ndarray   # [F, K] use input noise (not stationary)
    pred_valid: np.ndarray   # [F, K]
    z: np.ndarray            # [F, Zc, 3]
    z_mask: np.ndarray       # [F, Zc]
    scans: np.ndarray | None  # [F, 361] raw scans or None
    gps: np.ndarray          # [G, 3] (t, x, y)
    dr_pose: np.ndarray      # [F, 3] dead-reckoned pose at scan times


def load(data_dir: str, scale_ur: float = 1.0, z_capacity: int = 24,
         n_messages: int = 0, ackerman=(0.76, 2.83, 3.78, 0.5)):
    """Build frames from the dataset directory."""
    sm = _loadtxt(os.path.join(data_dir, "Sensors_manager.txt"))
    inputs = _loadtxt(os.path.join(data_dir, "inputs.dat"))
    meas = _loadtxt(os.path.join(data_dir, "measurements.dat"))
    gps = _loadtxt(os.path.join(data_dir, "gps.dat"))
    laser_path = os.path.join(data_dir, "LASER.txt")
    scans_raw = None
    if os.path.exists(laser_path):
        vals = np.fromfile(laser_path, sep=" ")
        scans_raw = vals.reshape(-1, 362)  # t + 361 ranges

    if n_messages and n_messages < len(sm):
        sm = sm[:n_messages]

    # detections grouped by timestamp
    z_by_t: dict = {}
    for row in meas:
        z_by_t.setdefault(round(row[0], 6), []).append(row[1:4])

    frames_t = []
    frames_pred = []        # list of list[(dt, u, noise)]
    frames_z = []
    frames_scan_idx = []
    cur_pred = []
    t_km = 0.0
    u_km = np.zeros(2)
    stationary = True

    for row in sm:
        t_k, typ, idx = float(row[0]), int(row[1]), int(row[2]) - 1
        if typ == 2:  # Input
            dt = t_k - t_km
            cur_pred.append((dt, u_km.copy(), not stationary))
            u_km = inputs[idx, 1:3].copy()
            u_km[1] *= scale_ur
            if u_km[0] != 0:
                stationary = False
            t_km = t_k
        elif typ == 3:  # Lidar
            dt = t_k - t_km
            cur_pred.append((dt, u_km.copy(), not stationary))
            t_km = t_k
            frames_t.append(t_k)
            frames_pred.append(cur_pred)
            cur_pred = []
            frames_z.append(z_by_t.get(round(t_k, 6), []))
            frames_scan_idx.append(idx)
        # GPS messages (typ 1) are ignored by the filter loop

    F = len(frames_t)
    K = max(len(p) for p in frames_pred)
    Zc = z_capacity
    zmax_seen = max((len(z) for z in frames_z), default=0)
    if zmax_seen > Zc:
        raise ValueError(f"z_capacity {Zc} < max detections per scan {zmax_seen}")

    pred_dt = np.zeros((F, K))
    pred_u = np.zeros((F, K, 2))
    pred_noise = np.zeros((F, K), bool)
    pred_valid = np.zeros((F, K), bool)
    z = np.zeros((F, Zc, 3))
    z_mask = np.zeros((F, Zc), bool)
    for j, preds in enumerate(frames_pred):
        for i, (dt, u, noise) in enumerate(preds):
            pred_dt[j, i] = dt
            pred_u[j, i] = u
            pred_noise[j, i] = noise
            pred_valid[j, i] = True
        for i, zz in enumerate(frames_z[j]):
            z[j, i] = zz
            z_mask[j, i] = True

    scans = None
    if scans_raw is not None:
        scan_by_idx = scans_raw[:, 1:]
        scans = np.zeros((F, 361))
        for j, idx in enumerate(frames_scan_idx):
            if idx < len(scan_by_idx):
                scans[j] = scan_by_idx[idx]

    dr_pose = dead_reckoning(pred_dt, pred_u, pred_valid, ackerman)
    return VPFrames(
        t=np.asarray(frames_t), pred_dt=pred_dt, pred_u=pred_u,
        pred_noise=pred_noise, pred_valid=pred_valid, z=z, z_mask=z_mask,
        scans=scans, gps=gps, dr_pose=dr_pose,
    )


def dead_reckoning(pred_dt, pred_u, pred_valid, ackerman):
    """Noise-free Ackerman integration at scan times
    (rbphdslam_VictoriaPark.cpp:327-357)."""
    h, l, dx_, dy_ = ackerman
    pose = np.zeros(3)
    out = np.zeros((pred_dt.shape[0], 3))
    for j in range(pred_dt.shape[0]):
        for i in range(pred_dt.shape[1]):
            if not pred_valid[j, i]:
                continue
            dt = pred_dt[j, i]
            v, r = pred_u[j, i]
            tan_r = np.tan(r)
            v = v / (1 - tan_r * h / l)
            c, s = np.cos(pose[2]), np.sin(pose[2])
            pose = pose + dt * np.array([
                v * c - v / l * tan_r * (dx_ * s + dy_ * c),
                v * s + v / l * tan_r * (dx_ * c - dy_ * s),
                v / l * tan_r,
            ])
            if pose[2] > np.pi:
                pose[2] -= 2 * np.pi
            elif pose[2] < -np.pi:
                pose[2] += 2 * np.pi
        out[j] = pose
    return out
