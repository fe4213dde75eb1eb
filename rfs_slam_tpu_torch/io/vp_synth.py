"""A seeded synthetic Victoria Park stream, written in the dataset's own file
formats (the reference reads them in rbphdslam_VictoriaPark.cpp:199-324;
:func:`rfs_slam_tpu_torch.io.victoria_park.load` buckets them into frames).

A data source for tests and the chip smoke, like :mod:`io.sim2d`: the real
dataset is not in the repository, so this stream stands in for it at its
scale.  Everything comes from ``np.random.default_rng(seed)``:

* 400 trees uniform in a 300 m x 300 m square centred on the start, at
  least 2 m apart, diameters uniform in 0.15-0.8 m;
* an Ackerman vehicle (the dataset's geometry) starting at the origin with
  heading 0, speed 2-4 m/s, steering smoothly toward random waypoints that
  keep it inside the square; its true inputs are held between messages as
  the filter holds them, and written at 40 Hz with N(0, diag(0.1^2,
  0.02^2)) noise (well inside the filter's input-noise model, so its
  proposal covers the truth, while dead reckoning drifts);
* a lidar scan after every 8 or 9 inputs (8.6 on average); each tree whose
  geometry-only Pd (the measurement model's multi-probe Pd without a scan
  or a covariance) is positive is detected with that probability, as
  ``[r, b, d]`` + N(0, diag(0.025, 2.5e-5, 2e-3)), plus Poisson(3) clutter
  uniform in the sensing sector; at most 24 detections per scan, nearest
  first;
* GPS: the true sensor-point position at the first scan of every second,
  so a fix and a filter estimate share their time;
* with ``scans``: ``LASER.txt``, 361 beams over the lidar's half circle
  ray-cast against the tree discs, 75 m where a beam hits nothing (as
  ``scripts/synth_laser.py`` writes it).

The Pd table of :data:`PD_TABLE` stands in for the dataset's XML config;
:func:`write_config` writes it as a config file that the app's ``build``
reads, every other setting taking ``build``'s defaults.

Usage::

    python -m rfs_slam_tpu_torch.io.vp_synth --out DIR [--seed 0]
        [--frames 7230] [--scans]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

N_TREES = 400
SQUARE = 300.0
MIN_SPACING = 2.0
DIAMETER = (0.15, 0.8)
ACKERMAN = (0.76, 2.83, 3.78, 0.5)   # h, l, sensor offset x, y
SPEED = (2.0, 4.0)
INPUT_HZ = 40.0
INPUT_STD = (0.1, 0.02)              # speed (m/s), steering (rad)
Z_VAR = (0.025, 2.5e-5, 2e-3)        # range, bearing, diameter
CLUTTER_MEAN = 3.0
R_LIM = (5.0, 70.0)
B_LIM = (6.3 * np.pi / 180.0, 177.0 * np.pi / 180.0)
Z_CAPACITY = 24
PD_TABLE = (0.0, 0.2, 0.4, 0.6, 0.8, 0.9)
LASER_RANGE = 75.0
N_PROBE_PAIRS = 3
MAX_STEER = 0.35
STEER_RATE = 0.3                     # rad/s
WAYPOINT_BOX = 120.0                 # waypoints in [-120, 120]^2
WAYPOINT_REACHED = 10.0


def _wrap(a):
    return a - 2.0 * np.pi * np.round(a / (2.0 * np.pi))


def ackerman_step(pose, v, r, dt, ackerman=ACKERMAN):
    """One Ackerman step of the sensor-point pose (the filter's model,
    ProcessModel_Ackerman2D.cpp:49-77)."""
    h, l, dx, dy = ackerman
    tan_r = np.tan(r)
    v = v / (1.0 - tan_r * h / l)
    c, s = np.cos(pose[2]), np.sin(pose[2])
    th = pose[2] + dt * v / l * tan_r
    if th > np.pi:
        th -= 2.0 * np.pi
    elif th < -np.pi:
        th += 2.0 * np.pi
    return np.array([
        pose[0] + dt * (v * c - v / l * tan_r * (dx * s + dy * c)),
        pose[1] + dt * (v * s + v / l * tan_r * (dx * c - dy * s)),
        th])


def _pd_single(pose, lx, ly, diameter, pd_table):
    """Geometry-only Pd of discs (probabilityOfDetection2 without a scan,
    MeasurementModel_VictoriaPark.cpp:202-265)."""
    K = len(pd_table)
    dx, dy = lx - pose[0], ly - pose[1]
    rng = np.sqrt(dx * dx + dy * dy)
    ang = _wrap(np.arctan2(dy, dx) - (pose[2] - np.pi / 2.0))
    in_limits = ((ang <= B_LIM[1]) & (ang >= B_LIM[0])
                 & (rng >= R_LIM[0]) & (rng <= R_LIM[1]))
    gamma = np.arctan(diameter / 2.0 / np.maximum(rng, 1e-9))
    max_pts = np.floor(2.0 * gamma * 720.0 / (2.0 * np.pi)).astype(np.int64)
    pd = pd_table[np.clip(max_pts, 0, K - 1)]
    return np.where(in_limits, pd, 0.0)


def geometric_pd(pose, lx, ly, diameter, pd_table=PD_TABLE):
    """The measurement model's multi-probe Pd without a scan or a
    covariance (probe std 0.2 m; MeasurementModel_VictoriaPark.cpp:153-199)."""
    pd_table = np.asarray(pd_table)
    bearing = np.arctan2(ly - pose[1], lx - pose[0])
    px, py = -np.sin(bearing), np.cos(bearing)
    pd = _pd_single(pose, lx, ly, diameter, pd_table)
    for i in range(1, N_PROBE_PAIRS + 1):
        valid = (i - 1) * 2.0 * diameter < 0.2
        for sgn in (1.0, -1.0):
            off = sgn * i * 2.0 * diameter
            pd_i = _pd_single(pose, lx + off * px, ly + off * py, diameter,
                              pd_table)
            pd = np.maximum(pd, np.where(valid, pd_i, pd))
    return pd


def trees(rng):
    """[N_TREES, 3] (x, y, diameter), at least MIN_SPACING apart."""
    pts = []
    while len(pts) < N_TREES:
        c = rng.uniform(-SQUARE / 2, SQUARE / 2, size=2)
        if all((c[0] - p[0]) ** 2 + (c[1] - p[1]) ** 2 >= MIN_SPACING ** 2
               for p in pts):
            pts.append(c)
    d = rng.uniform(*DIAMETER, size=N_TREES)
    return np.column_stack([np.asarray(pts), d])


def laser_scan(pose, forest):
    """361 beam ranges over the lidar's half circle: the nearest tree-disc
    hit, LASER_RANGE where a beam hits nothing closer."""
    th = pose[2] - np.pi / 2.0
    rel = forest[:, :2] - pose[:2]
    rad = forest[:, 2] / 2.0
    near = np.hypot(rel[:, 0], rel[:, 1]) < LASER_RANGE + rad
    rel, rad = rel[near], rad[near]
    a = th + np.arange(361) * np.pi / 360.0
    u = np.stack([np.cos(a), np.sin(a)], -1)                  # [361, 2]
    t_ca = u @ rel.T                                          # [361, n]
    d2 = (rel * rel).sum(1)[None, :] - t_ca * t_ca
    hit = (t_ca > 0) & (d2 <= rad[None, :] ** 2)
    t_hit = np.where(hit, t_ca - np.sqrt(np.maximum(rad[None, :] ** 2 - d2,
                                                    0.0)), np.inf)
    r = t_hit.min(axis=1, initial=np.inf)
    return np.where(r < LASER_RANGE, r, LASER_RANGE)


def _detect(rng, pose, forest):
    """One scan's detections [n, 3] (range, bearing, diameter), nearest
    first, and the number dropped past Z_CAPACITY."""
    pd = geometric_pd(pose, forest[:, 0], forest[:, 1], forest[:, 2])
    seen = forest[rng.uniform(size=len(forest)) < pd]
    dx, dy = seen[:, 0] - pose[0], seen[:, 1] - pose[1]
    z = np.column_stack([np.hypot(dx, dy),
                         _wrap(np.arctan2(dy, dx) - (pose[2] - np.pi / 2.0)),
                         seen[:, 2]])
    z = z + rng.normal(size=z.shape) * np.sqrt(Z_VAR)
    n_c = rng.poisson(CLUTTER_MEAN)
    clutter = np.column_stack([rng.uniform(*R_LIM, size=n_c),
                               rng.uniform(*B_LIM, size=n_c),
                               rng.uniform(*DIAMETER, size=n_c)])
    z = np.concatenate([z, clutter])
    z = z[np.argsort(z[:, 0], kind="stable")]
    return z[:Z_CAPACITY], max(len(z) - Z_CAPACITY, 0)


def write(out_dir: str, seed: int, n_frames: int = 7230,
          scans: bool = False) -> int:
    """Write ``Sensors_manager.txt``, ``inputs.dat``, ``measurements.dat``,
    ``gps.dat`` (and ``LASER.txt`` with ``scans``) for ``n_frames`` lidar
    scans into ``out_dir``.  Returns the number of detections dropped past
    the 24 per scan."""
    rng = np.random.default_rng(seed)
    forest = trees(rng)
    speed_phase = rng.uniform(0, 2 * np.pi)
    dt_in = 1.0 / INPUT_HZ

    def waypoint():
        return rng.uniform(-WAYPOINT_BOX, WAYPOINT_BOX, size=2)

    pose = np.zeros(3)
    u_true = np.zeros(2)        # held between messages, as the filter does
    steer = 0.0
    wp = waypoint()
    t_prev = 0.0
    events, inputs, meas, gps, laser = [], [], [], [], []
    dropped = 0
    k_in = 0
    next_gps = 1.0
    for n_scan in range(1, n_frames + 1):
        for _ in range(8 + int(rng.uniform() < 0.6)):
            k_in += 1
            t = k_in * dt_in
            pose = ackerman_step(pose, u_true[0], u_true[1], t - t_prev)
            t_prev = t
            if np.hypot(*(wp - pose[:2])) < WAYPOINT_REACHED:
                wp = waypoint()
            err = _wrap(np.arctan2(wp[1] - pose[1], wp[0] - pose[0])
                        - pose[2])
            target = np.clip(0.8 * err, -MAX_STEER, MAX_STEER)
            steer += np.clip(target - steer, -STEER_RATE * dt_in,
                             STEER_RATE * dt_in)
            v = (SPEED[0] + SPEED[1]) / 2 + 0.45 * (SPEED[1] - SPEED[0]) \
                * np.sin(2 * np.pi * t / 53.0 + speed_phase)
            u_true = np.array([v, steer])
            noisy = u_true + rng.normal(size=2) * np.asarray(INPUT_STD)
            inputs.append((t, *noisy))
            events.append((t, 2, len(inputs)))
        t = k_in * dt_in + dt_in / 2
        pose = ackerman_step(pose, u_true[0], u_true[1], t - t_prev)
        t_prev = t
        z, n_drop = _detect(rng, pose, forest)
        dropped += n_drop
        meas.extend((t, *row) for row in z)
        if t >= next_gps:
            gps.append((t, pose[0], pose[1]))
            events.append((t, 1, len(gps)))
            next_gps = np.floor(t) + 1.0
        if scans:
            laser.append((t, laser_scan(pose, forest)))
        events.append((t, 3, n_scan))

    os.makedirs(out_dir, exist_ok=True)

    def dump(name, rows, fmt):
        with open(os.path.join(out_dir, name), "w") as f:
            for row in rows:
                f.write(fmt % tuple(row) + "\n")

    dump("Sensors_manager.txt", events, "%.6f %d %d")
    dump("inputs.dat", inputs, "%.6f %.9f %.9f")
    dump("measurements.dat", meas, "%.6f %.9f %.9f %.9f")
    dump("gps.dat", gps, "%.6f %.9f %.9f")
    if scans:
        with open(os.path.join(out_dir, "LASER.txt"), "w") as f:
            for t, r in laser:
                f.write(" ".join([f"{t:.6f}"] + [f"{v:.4f}" for v in r]))
                f.write("\n")
    return dropped


def write_config(path: str, pd_table=PD_TABLE) -> str:
    """An XML config holding only the Pd table (``measurements.Pd``); every
    other setting takes the app's ``build`` defaults."""
    values = "".join(f"<value>{p}</value>" for p in pd_table)
    with open(path, "w") as f:
        f.write(f"<config><measurements><Pd>{values}</Pd></measurements>"
                "</config>\n")
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=7230)
    ap.add_argument("--scans", action="store_true")
    args = ap.parse_args(argv)
    dropped = write(args.out, args.seed, args.frames, args.scans)
    cfg = write_config(os.path.join(args.out, "config.xml"))
    print(f"{args.frames} frames -> {args.out} ({dropped} detections "
          f"dropped past {Z_CAPACITY} per scan); config {cfg}")


if __name__ == "__main__":
    main()
