"""Reference-format .dat log writers/readers (a copy of the JAX package's
``io/logs.py``).  particlePose.dat and landmarkEst.dat go through the
native writers of :mod:`rfs_slam_tpu_torch.io.native` when its library
builds, else through the Python writers ``python_*`` here; both write the
same bytes.

The reference's analysis and animation toolchain consumes fixed-column
whitespace-separated text logs (formats per rbphdslam2dSim.cpp:369-441 and
:609-641).  These writers produce the same formats, so the reference's own
Python animators / analysis flows work unchanged:

* gtPose.dat:         t x y theta
* gtLandmark.dat:     x y firstObservedTime
* odometry.dat:       t dx dy dtheta
* measurement.dat:    t r b
* deadReckoning.dat:  t x y theta
* particlePose.dat:   t i x y theta w          (blank line between steps)
* landmarkEst.dat:    t i x y Sxx Sxy Syy w    (best particle only)
* trajectory.dat:     t x y theta              (best-particle path)
* timing.dat:         phase wall_ns cpu_ns
"""

from __future__ import annotations

import os

import numpy as np

from rfs_slam_tpu_torch.io import native


def _open(logdir: str, name: str):
    os.makedirs(logdir, exist_ok=True)
    return open(os.path.join(logdir, name), "w")


def write_sim_data(logdir: str, data, dt: float = 0.1,
                   cfg_src_path: str | None = None) -> None:
    """gtPose/gtLandmark/odometry/measurement/deadReckoning.dat
    (rbphdslam2dSim.cpp:369-441); copies the config for provenance."""
    if cfg_src_path:
        import shutil

        os.makedirs(logdir, exist_ok=True)
        shutil.copy(cfg_src_path, os.path.join(logdir, "simSettings.xml"))

    T = data.gt_pose.shape[0]
    with _open(logdir, "gtPose.dat") as f:
        for k in range(T):
            t = k * dt
            f.write("%f   %f   %f   %f\n" % (t, *data.gt_pose[k]))
    with _open(logdir, "gtLandmark.dat") as f:
        for m in range(len(data.landmarks)):
            f.write("%f   %f   %f\n" % (data.landmarks[m][0],
                                        data.landmarks[m][1],
                                        data.lmk_first_obs[m]))
    with _open(logdir, "odometry.dat") as f:
        for k in range(T):
            t = k * dt
            f.write("%f   %f   %f   %f\n" % (t, *data.odometry[k]))
    with _open(logdir, "measurement.dat") as f:
        for k in range(T):
            t = k * dt
            for j in range(data.z.shape[1]):
                if data.z_mask[k, j]:
                    f.write("%f   %f   %f\n" % (t, data.z[k, j, 0], data.z[k, j, 1]))
    with _open(logdir, "deadReckoning.dat") as f:
        for k in range(T):
            t = k * dt
            f.write("%f   %f   %f   %f\n" % (t, *data.dr_pose[k]))


def write_particle_poses(logdir: str, times, poses, weights) -> None:
    """particlePose.dat: t i x y theta w with blank separators
    (rbphdslam2dSim.cpp:609-632).  ``poses``: [T, P, 3]; ``weights``: [T, P].
    """
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "particlePose.dat")
    if not native.write_particle_poses(path, times, poses, weights):
        python_particle_poses(path, times, poses, weights)


def python_particle_poses(path: str, times, poses, weights) -> None:
    """The Python particlePose.dat writer (the path without a compiler)."""
    T, P, _ = poses.shape
    with open(path, "w") as f:
        # initial block at t=0, weight 1.0 (rbphdslam2dSim.cpp:536-541)
        for i in range(P):
            f.write("%f   %d   %f   %f   %f   1.0\n" % (0.0, i, 0.0, 0.0, 0.0))
        for k in range(T):
            for i in range(P):
                f.write("%f   %d   %f   %f   %f   %f\n" % (
                    times[k], i, poses[k, i, 0], poses[k, i, 1],
                    poses[k, i, 2], weights[k, i]))
            f.write("\n")


def write_landmark_estimates(logdir: str, times, best_idx, means, covs,
                             weights, alive) -> None:
    """landmarkEst.dat: t i x y Sxx Sxy Syy w — best particle's map per step
    (rbphdslam2dSim.cpp:634-641).  ``means``: [T, M, 2]; ``covs``: [T, M, 2, 2]
    (or packed [T, M, 3]); ``weights``/``alive``: [T, M].
    """
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "landmarkEst.dat")
    packed = covs if covs.ndim == 3 else np.stack(
        [covs[..., 0, 0], covs[..., 0, 1], covs[..., 1, 1]], axis=-1)
    args = (times, best_idx, means[..., :2], packed, weights, alive)
    if not native.write_landmark_estimates(path, *args):
        python_landmark_estimates(path, *args)


def python_landmark_estimates(path: str, times, best_idx, means, covs,
                              weights, alive) -> None:
    """The Python landmarkEst.dat writer (packed ``covs`` [T, M, 3])."""
    with open(path, "w") as f:
        for k in range(means.shape[0]):
            for m in range(means.shape[1]):
                if not alive[k, m]:
                    continue
                sxx, sxy, syy = covs[k, m]
                f.write("%f   %d   %f   %f      %f   %f   %f   %f\n" % (
                    times[k], best_idx[k], means[k, m, 0], means[k, m, 1],
                    sxx, sxy, syy, weights[k, m]))


def write_trajectory(logdir: str, times, poses) -> None:
    """trajectory.dat: best-particle path (rbphdslam_VictoriaPark.cpp:631-660)."""
    with _open(logdir, "trajectory.dat") as f:
        for k in range(len(times)):
            f.write("%f   %f   %f   %f\n" % (times[k], *poses[k]))


def ancestral_path(poses, parents, final_idx):
    """Best-particle trajectory via the resampling ancestry chain.

    The reference extracts the final best particle's *consistent* history by
    walking the ``Trajectory`` prev-chain (rbphdslam_VictoriaPark.cpp:631-660,
    Trajectory.hpp:39-58).  Here ``parents[k]`` is the per-step ancestor map
    recorded by the filter (identity when no resample happened at step k), so
    the same chain is a backward index walk:

        idx_{k} = parents[k+1][idx_{k+1}]

    Args:
      poses: [T, P, 3] per-step post-update particle poses.
      parents: [T, P] int ancestor indices (into step k-1's particle array).
      final_idx: index of the particle whose history to extract (the
        highest-weight particle at the final step).

    Returns:
      [T, 3] the particle's consistent pose history.
    """
    poses = np.asarray(poses)
    parents = np.asarray(parents)
    T = poses.shape[0]
    out = np.zeros((T, poses.shape[2]), poses.dtype)
    idx = int(final_idx)
    out[T - 1] = poses[T - 1, idx]
    for k in range(T - 2, -1, -1):
        idx = int(parents[k + 1, idx])
        out[k] = poses[k, idx]
    return out


def write_timing(logdir: str, timing: dict) -> None:
    """timing.dat: phase wall_ns cpu_ns (rbphdslam2dSim.cpp:654-732).

    ``timing`` maps phase -> (wall_s, host_cpu_s) as produced by
    utils.timing.PhaseTimer.report().  The cpu column is HOST process CPU
    time (dispatch overhead) — device work shows in the wall column only;
    a header comment in the file says so.  Legacy scalar values write the
    wall figure to both columns.
    """
    with _open(logdir, "timing.dat") as f:
        f.write("# phase   wall_ns   host_cpu_ns "
                "(host CPU = dispatch overhead; device time is wall)\n")
        for phase, v in timing.items():
            wall_s, cpu_s = v if isinstance(v, (tuple, list)) else (v, v)
            f.write("%s   %d   %d\n" % (phase, int(wall_s * 1e9),
                                        int(cpu_s * 1e9)))


def read_particle_poses(path: str):
    """Parse particlePose.dat back into [T, P, 3] poses + [T, P] weights."""
    raw = np.loadtxt(path)
    times = np.unique(raw[:, 0])
    P = int(raw[:, 1].max()) + 1
    T = len(times)
    poses = np.zeros((T, P, 3))
    weights = np.zeros((T, P))
    t_index = {t: i for i, t in enumerate(times)}
    for row in raw:
        k = t_index[row[0]]
        i = int(row[1])
        poses[k, i] = row[2:5]
        weights[k, i] = row[5]
    return times, poses, weights
