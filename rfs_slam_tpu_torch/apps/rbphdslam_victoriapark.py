"""RB-PHD SLAM on the Victoria Park stream (port of the JAX package's
``apps/rbphdslam_victoriapark.py``; the reference executable is
rbphdslam_VictoriaPark.cpp).

``build`` wires the filter from a reference-format XML config (the same
keys and defaults as the JAX app): Ackerman motion with input noise, 3-D
landmarks ``[x, y, diameter]`` with per-dt^2 growth, the VictoriaPark
measurement model, and the birth-candidate state machine.  ``run`` drives
one lidar frame per Python iteration on the filter's device: births once
per frame, the frame's valid predict substeps, then the update.  Per-frame
outputs stay on the device and reach the host once a chunk, in the chunked
loop of ``apps/_vp_common.py``, which also checkpoints and resumes the run.

Usage (the synthetic stream of ``io/vp_synth.py`` stands in for the
dataset, which the repository does not hold)::

    python -m rfs_slam_tpu_torch.io.vp_synth --out DIR
    python -m rfs_slam_tpu_torch.apps.rbphdslam_victoriapark \\
        --cfg DIR/config.xml --data DIR [--messages N] [--device cpu] \\
        [--ckpt-dir CKPT --ckpt-every 500 [--resume | --resume-at F]]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from rfs_slam_tpu_torch.apps import _vp_common
from rfs_slam_tpu_torch.apps.sim2d_common import device_for
from rfs_slam_tpu_torch.filters.rbphd import RBPHDConfig, RBPHDFilter
from rfs_slam_tpu_torch.io import logs
from rfs_slam_tpu_torch.io import victoria_park as vp_io
from rfs_slam_tpu_torch.io.xmlconfig import XmlConfig
from rfs_slam_tpu_torch.models.motion import Ackerman2D, StaticLandmark
from rfs_slam_tpu_torch.models.victoria_park import (VictoriaPark,
                                                     fov_area_clutter)
from rfs_slam_tpu_torch.ops.ekf import InnovationGates

Z_CAPACITY = 24
MAP_CAPACITY = 512


def vp_models(cfg: XmlConfig, device: torch.device):
    """The models both Victoria Park apps wire from the XML (the JAX apps'
    keys and defaults): ``(motion, landmark model, measurement model,
    gates, input_cov [2, 2], ackerman geometry)``, tensors on
    ``device``."""
    def ten(a):
        # formed in float64, rounded once, as the JAX package rounds it
        return torch.tensor(np.asarray(a), dtype=torch.float32,
                            device=device)

    z_infl = cfg.get("filter.update.measurementNoiseInflationFactor", 1.0)
    ack = (
        cfg.get("process.AckermanModel.rearWheelOffset", 0.76),
        cfg.get("process.AckermanModel.frontToRearDist", 2.83),
        cfg.get("process.AckermanModel.sensorOffset_x", 3.78),
        cfg.get("process.AckermanModel.sensorOffset_y", 0.5),
    )
    motion = Ackerman2D(Q=ten(np.zeros((3, 3))), h=ack[0], l=ack[1],
                        dx=ack[2], dy=ack[3])
    input_cov = ten(np.diag([cfg.get("process.varuv", 0.2),
                             cfg.get("process.varur", 0.025)]))
    lmk = StaticLandmark(
        Q=ten(np.diag([cfg.get("landmarks.varlmx", 5e-4),
                       cfg.get("landmarks.varlmy", 5e-4),
                       cfg.get("landmarks.varlmd", 1e-4)])),
        per_dt2=True)
    R = np.diag([cfg.get("measurements.varzr", 0.025),
                 cfg.get("measurements.varzb", 2.5e-5),
                 cfg.get("measurements.varzd", 2e-3)]) * z_infl
    b_min = cfg.get("measurements.bearingLimitMin", 6.3) * np.pi / 180
    b_max = cfg.get("measurements.bearingLimitMax", 177.0) * np.pi / 180
    r_min = cfg.get("measurements.rangeLimitMin", 5.0)
    r_max = cfg.get("measurements.rangeLimitMax", 70.0)
    expected_clutter = cfg.get("measurements.expectedNClutter", 3.0)
    meas = VictoriaPark(
        R=ten(R), slb=ten(cfg.get("measurements.varza", 1e-5)),
        pd_table=ten(cfg.get_list("measurements.Pd", "value")),
        clutter_value=ten(fov_area_clutter(expected_clutter, r_min, r_max,
                                           b_min, b_max)),
        scan720=torch.zeros(720, device=device),
        r_max=r_max, r_min=r_min, b_max=b_max, b_min=b_min,
        buffer_pd=cfg.get("measurements.bufferZonePd", 0.4),
        expected_clutter=expected_clutter)
    gates = InnovationGates.victoria_park(
        cfg.get("filter.update.KalmanFilter.innovationThreshold.range", -1.0),
        cfg.get("filter.update.KalmanFilter.innovationThreshold.bearing",
                -1.0))
    return motion, lmk, meas, gates, input_cov, ack


def build(cfg: XmlConfig, z_capacity: int = Z_CAPACITY,
          map_capacity: int = MAP_CAPACITY, n_particles: int | None = None,
          z_dp_max: int = 8, device: torch.device | None = None):
    """Wiring per rbphdslam_VictoriaPark.cpp:360-400.  Returns ``(filter,
    input_cov [2, 2], ackerman geometry)``, tensors on ``device``: the card
    unless the caller asks for the CPU.  Raises where no card is."""
    motion, lmk, meas, gates, input_cov, ack = vp_models(cfg,
                                                        device_for(device))
    n_particles = n_particles or cfg.get("filter.nParticles", 100, int)
    fcfg = RBPHDConfig(
        n_particles=n_particles,
        map_capacity=map_capacity,
        z_capacity=z_capacity,
        new_capacity=48,
        birth_capacity=24,
        eval_capacity=cfg.get("filter.weighting.nEvalPt", 15, int),
        z_dp_max=z_dp_max,
        birth_gaussian_weight=cfg.get("filter.predict.birthGaussian.Weight",
                                      0.01),
        birth_count_threshold=cfg.get(
            "filter.predict.birthGaussian.SupportMeasurementThreshold", 5,
            int),
        birth_check_threshold=cfg.get(
            "filter.predict.birthGaussian.CheckCountThreshold", 10, int),
        birth_support_dist=cfg.get(
            "filter.predict.birthGaussian.SupportMeasurementDist", 2.0),
        birth_current_meas_count_threshold=cfg.get(
            "filter.predict.birthGaussian.CurrentMeasurementCountThreshold",
            2, int),
        new_gaussian_md_threshold=cfg.get(
            "filter.update.GaussianCreateInnovMDThreshold", 3.0),
        eval_pt_min_weight=cfg.get("filter.weighting.minWeight", 0.75),
        weighting_md_threshold=cfg.get("filter.weighting.threshold", 3.0),
        merge_threshold=cfg.get("filter.merge.threshold", 0.5),
        merge_inflation=cfg.get("filter.merge.covInflationFactor", 1.0),
        prune_threshold=cfg.get("filter.prune.threshold", 0.01),
        min_updates_before_resample=cfg.get(
            "filter.resampling.minTimesteps", 1, int),
        min_measurements_before_resample=cfg.get(
            "filter.resampling.minMeasurements", 0, int),
        ess_threshold=cfg.get("filter.resampling.effNParticle",
                              float(n_particles)),
        use_cluster_process=cfg.get("filter.weighting.useClusterProcess",
                                    False, bool),
    )
    return RBPHDFilter(motion, lmk, meas, gates, fcfg), input_cov, ack


def head(frames: vp_io.VPFrames, n: int) -> vp_io.VPFrames:
    """The first ``n`` frames of a stream (the GPS fixes are kept whole:
    :func:`gps_rmse` scores only fixes within 0.5 s of a frame)."""
    cut = {f.name: getattr(frames, f.name)
           for f in dataclasses.fields(frames)}
    for k, v in cut.items():
        if k != "gps" and v is not None:
            cut[k] = v[:n]
    return vp_io.VPFrames(**cut)


def step_frame(filt: RBPHDFilter, state, meas, dts, u, noise, input_cov,
               z, z_mask, has_z: bool, gen: torch.Generator | None = None,
               input_noise=None, u0=None, mesh=None):
    """One lidar frame: births with the frame's model ``meas`` (the first
    predict after an update checks births, rbphdslam_VictoriaPark.cpp:
    512-517), the predict substeps, then the update.

    ``dts`` [K] float32 and ``noise`` [K] bool are host arrays; ``u`` [K, 2]
    the held inputs.  Substeps with dt = 0 (the frame's padding) are exact
    no-ops and are skipped.  ``input_noise`` [K, P, 2] and ``u0`` inject
    the draws, else they come from ``gen``.  ``mesh``: the state is this
    rank's block of the particle axis (``_vp_common.make_frame_step``).
    """
    gm, birth = filt._add_birth_gaussians(state, meas)
    state = dataclasses.replace(state, gm=gm, birth=birth)
    for i in np.nonzero(dts)[0]:
        state = filt.predict(
            state, u[i], float(dts[i]), gen=gen, use_model_noise=False,
            use_input_noise=bool(noise[i]), input_cov=input_cov,
            input_noise=None if input_noise is None else input_noise[i],
            birth_check=False)
    return filt.update(state, z, z_mask, u0=u0, gen=gen, has_z=has_z,
                       meas=meas, mesh=mesh)


def run(filt: RBPHDFilter, input_cov: torch.Tensor, frames: vp_io.VPFrames,
        gen: torch.Generator, artificial_clutter: float = 0.0,
        clutter_seed: int = 0, **chunking):
    """Run the filter over the frame stream on ``gen``'s device: each frame
    is :func:`step_frame` with the frame's model and input noise per the
    host's flags, through :func:`_vp_common.run_stream`.  ``chunking``: the
    keyword arguments of :func:`_vp_common.chunked_scan` (``ckpt_dir``,
    ``ckpt_every``, ``resume``, ``resume_at``, ``ckpt_keep``, ``reseed``,
    ``check_reads``, ``progress``); a resumed run gives the unbroken run's
    result bit for bit.  Nothing inside a chunk reads the device.

    Returns ``(final state, outputs)``, the outputs numpy arrays over the
    frames: poses [F, P, 3], weights [F, P], best [F], the best particle's
    map means [F, M, 2], packed xy covariances [F, M, 3], weights and alive
    flags [F, M], and the resampling parents [F, P].
    """
    state = filt.init_state(torch.zeros(3, device=gen.device), dz=3, d=3)
    return _vp_common.run_stream(
        filt, step_frame, state, frames, gen, input_cov,
        lambda s: _vp_common.frame_outputs(s, torch.exp(s.particles.log_w)),
        artificial_clutter, clutter_seed, **chunking)


def gps_rmse(times, best_poses, gps):
    """Trajectory error against the GPS fixes (position only).

    Each fix is matched to the nearest estimate time on either side and
    scored when within 0.5 s.
    """
    right = np.clip(np.searchsorted(times, gps[:, 0]), 0, len(times) - 1)
    left = np.clip(right - 1, 0, len(times) - 1)
    d_right = np.abs(times[right] - gps[:, 0])
    d_left = np.abs(times[left] - gps[:, 0])
    idx = np.where(d_left < d_right, left, right)
    ok = np.abs(times[idx] - gps[:, 0]) < 0.5
    if ok.sum() == 0:
        return float("nan")
    d = best_poses[idx[ok], :2] - gps[ok, 1:3]
    return float(np.sqrt(np.mean(np.sum(d * d, axis=1))))


def trajectory_rmse(frames: vp_io.VPFrames, outs) -> tuple[float, float]:
    """(RMSE of the final best particle's ancestral path, dead reckoning's
    RMSE) against the stream's GPS fixes."""
    path = logs.ancestral_path(outs["pose"], outs["parent"],
                               outs["best"][-1])
    return (gps_rmse(frames.t, path, frames.gps),
            gps_rmse(frames.t, frames.dr_pose, frames.gps))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--data", required=True)
    ap.add_argument("--messages", type=int, default=None,
                    help="process only the first N sensor messages")
    ap.add_argument("--logdir", default=None)
    ap.add_argument("--particles", type=int, default=None)
    ap.add_argument("--map-capacity", type=int, default=MAP_CAPACITY)
    ap.add_argument("--z-dp-max", type=int, default=8,
                    help="exact-DP column budget of the RFS likelihood")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "twins)")
    _vp_common.add_ckpt_args(ap)
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    cfg = XmlConfig(args.cfg)
    n_msgs = args.messages if args.messages is not None else cfg.get(
        "filter.nMsgToProcess", 0, int)
    filt, input_cov, ack = build(cfg, map_capacity=args.map_capacity,
                                 n_particles=args.particles,
                                 z_dp_max=args.z_dp_max, device=dev)
    frames = vp_io.load(args.data, scale_ur=cfg.get("process.ur_scale", 1.0),
                        z_capacity=Z_CAPACITY, n_messages=n_msgs,
                        ackerman=ack)
    F = len(frames.t)
    print(f"victoriapark: {F} lidar frames, P={filt.cfg.n_particles}, "
          f"scans={'yes' if frames.scans is not None else 'no'}, "
          f"device={dev}")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.perf_counter()
    _, outs = run(filt, input_cov, frames, gen,
                  artificial_clutter=cfg.get("measurements.addedClutter", 0.0),
                  clutter_seed=args.seed, ckpt_dir=args.ckpt_dir,
                  ckpt_every=args.ckpt_every, resume=args.resume,
                  resume_at=args.resume_at, ckpt_keep=args.ckpt_keep,
                  reseed=args.reseed)
    wall = time.perf_counter() - t0
    print(f"done: {F} frames in {wall:.1f} s ({F / wall:.1f} frames/s)")
    rmse, dr_rmse = trajectory_rmse(frames, outs)
    stepwise = outs["pose"][np.arange(F), outs["best"]]
    print(f"trajectory RMSE vs GPS: {rmse:.2f} m  (per-step argmax: "
          f"{gps_rmse(frames.t, stepwise, frames.gps):.2f} m, dead "
          f"reckoning: {dr_rmse:.2f} m)")

    logdir = args.logdir or cfg.get("logging.logDirPrefix",
                                    "data/VictoriaPark/rbphdslam/results/",
                                    str)
    if cfg.get("logging.logResultsToFile", 0, int) or args.logdir:
        logs.write_particle_poses(logdir, frames.t, outs["pose"], outs["w"])
        logs.write_landmark_estimates(logdir, frames.t, outs["best"],
                                      outs["mean"], outs["cov"],
                                      outs["gm_w"], outs["alive"])
        logs.write_trajectory(logdir, frames.t, logs.ancestral_path(
            outs["pose"], outs["parent"], outs["best"][-1]))
        print(f"logs -> {logdir}")


if __name__ == "__main__":
    main()
