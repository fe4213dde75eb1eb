"""FastSLAM 1.0 / MH-FastSLAM on the Victoria Park stream (port of the JAX
package's ``apps/fastslam_victoriapark.py``; the reference executable is
fastslam_VictoriaPark.cpp).  MH-FastSLAM is selected by
``<maxNDataAssocHypotheses>`` in the XML (or ``--hypotheses``), as in the
reference.

``build`` reads the JAX app's XML keys with its defaults: the models of the
RB-PHD Victoria Park app (Ackerman motion with input noise, 3-D landmarks
``[x, y, diameter]``, the VictoriaPark measurement model and its gates) and
the FastSLAM configuration at the app's width (P=200, M=512, Zc=24, a DA
table of 32).  ``run`` takes one lidar frame per Python iteration on the
filter's device: the frame's valid predict substeps with input noise, then
the update with the frame's model.  Per-frame outputs reach the host once
a chunk, in the chunked loop of ``apps/_vp_common.py``, which also
checkpoints and resumes the run.

Usage (the synthetic stream of ``io/vp_synth.py`` stands in for the
dataset, which the repository does not hold)::

    python -m rfs_slam_tpu_torch.io.vp_synth --out DIR
    python -m rfs_slam_tpu_torch.apps.fastslam_victoriapark \\
        --cfg DIR/config.xml --data DIR [--messages N] [--hypotheses 3] \\
        [--device cpu] [--ckpt-dir CKPT --ckpt-every 500 [--resume]]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from rfs_slam_tpu_torch.apps import _vp_common
from rfs_slam_tpu_torch.apps.rbphdslam_victoriapark import (
    trajectory_rmse, vp_models)
from rfs_slam_tpu_torch.apps.sim2d_common import device_for
from rfs_slam_tpu_torch.filters.fastslam import FastSLAMConfig, FastSLAMFilter
from rfs_slam_tpu_torch.io import logs
from rfs_slam_tpu_torch.io import victoria_park as vp_io
from rfs_slam_tpu_torch.io.xmlconfig import XmlConfig

Z_CAPACITY = 24
MAP_CAPACITY = 512


def build(cfg: XmlConfig, z_capacity: int = Z_CAPACITY,
          map_capacity: int = MAP_CAPACITY, n_particles: int | None = None,
          hypotheses: int | None = None, window: float | None = None,
          murty_lane_budget: int | str | None = "auto",
          device: torch.device | None = None):
    """Wiring per fastslam_VictoriaPark.cpp:85-184, 360-400.  Returns
    ``(filter, input_cov [2, 2], ackerman geometry)``, tensors on
    ``device``: the card unless the caller asks for the CPU.  Raises where
    no card is.

    ``hypotheses`` / ``window`` override the XML's maxNDataAssocHypotheses
    / maxDataAssocLogLikelihoodDiff; ``murty_lane_budget="auto"`` is
    ``n_particles``, and None runs every lane's full Murty expansion."""
    motion, lmk, meas, gates, input_cov, ack = vp_models(cfg,
                                                        device_for(device))
    n_particles = n_particles or cfg.get("filter.nParticles", 200, int)
    if murty_lane_budget == "auto":
        murty_lane_budget = n_particles
    fcfg = FastSLAMConfig(
        n_particles=n_particles,
        map_capacity=map_capacity,
        z_capacity=z_capacity,
        nmz_capacity=max(z_capacity, 32),
        candidate_capacity=24,
        max_hypotheses=(hypotheses if hypotheses is not None else
                        cfg.get("filter.update.maxNDataAssocHypotheses", 1,
                                int)),
        murty_lane_budget=murty_lane_budget,
        max_da_loglik_diff=(window if window is not None else cfg.get(
            "filter.update.maxDataAssocLogLikelihoodDiff", 3.0)),
        min_log_likelihood=cfg.get(
            "filter.weighting.minLogMeasurementLikelihood", -10.0),
        lock_weight=cfg.get("filter.update.landmarkLockWeight", 10.0),
        prune_threshold=cfg.get("filter.prune.threshold", -5.0),
        prune_z_threshold=cfg.get("filter.prune.nMeasurementsThreshold", 0,
                                  int),
        cand_support_dist=cfg.get(
            "filter.update.landmarkCandidate.MeasurementSupportDist", 1.0),
        cand_count_threshold=cfg.get(
            "filter.update.landmarkCandidate.MeasurementCountThreshold", 1,
            int),
        cand_check_threshold=cfg.get(
            "filter.update.landmarkCandidate.MeasurementCheckThreshold", 2,
            int),
        cand_current_meas_count_threshold=cfg.get(
            "filter.update.landmarkCandidate."
            "CurrentMeasurementCountThreshold", 1, int),
        min_updates_before_resample=cfg.get(
            "filter.resampling.minTimesteps", 1, int),
        min_measurements_before_resample=cfg.get(
            "filter.resampling.minMeasurements", 0, int),
        ess_threshold=cfg.get("filter.resampling.effNParticle",
                              float(n_particles)),
    )
    return FastSLAMFilter(motion, lmk, meas, gates, fcfg), input_cov, ack


def step_frame(filt: FastSLAMFilter, state, meas, dts, u, noise, input_cov,
               z, z_mask, has_z: bool, gen: torch.Generator | None = None,
               input_noise=None, u0=None, mesh=None):
    """One lidar frame (fastslam_VictoriaPark.cpp's event loop, the JAX
    app's ``frame_step``): the predict substeps, then the update with the
    frame's model ``meas``.

    ``dts`` [K] float32 and ``noise`` [K] bool are host arrays; ``u`` [K, 2]
    the held inputs.  Substeps with dt = 0 (the frame's padding) are exact
    no-ops and are skipped.  ``input_noise`` [K, P, 2] and ``u0`` inject
    the draws, else they come from ``gen``.  ``mesh``: the state is this
    rank's block of the particle axis (``_vp_common.make_frame_step``).
    """
    for i in np.nonzero(dts)[0]:
        state = filt.predict(
            state, u[i], float(dts[i]), gen=gen, use_model_noise=False,
            use_input_noise=bool(noise[i]), input_cov=input_cov,
            input_noise=None if input_noise is None else input_noise[i])
    return filt.update(state, z, z_mask, u0=u0, gen=gen, has_z=has_z,
                       meas=meas, mesh=mesh)


def run(filt: FastSLAMFilter, input_cov: torch.Tensor,
        frames: vp_io.VPFrames, gen: torch.Generator,
        artificial_clutter: float = 0.0, clutter_seed: int = 0, **chunking):
    """Run the filter over the frame stream on ``gen``'s device: each frame
    is :func:`step_frame` with the frame's model and input noise per the
    host's flags, through :func:`_vp_common.run_stream`.  ``chunking``: the
    keyword arguments of :func:`_vp_common.chunked_scan` (``ckpt_dir``,
    ``ckpt_every``, ``resume``, ``resume_at``, ``ckpt_keep``, ``reseed``,
    ``check_reads``, ``progress``); a resumed run gives the unbroken run's
    result bit for bit.  Nothing inside a chunk reads the device.

    Returns ``(final state, outputs)``, the outputs numpy arrays over the
    frames: poses [F, P, 3], normalised weights [F, P], best [F], the best
    particle's map means [F, M, 2], packed xy covariances [F, M, 3],
    existence probabilities (the sigmoid of the log-odds) and alive flags
    [F, M], and the resampling parents [F, P]; P is the particle axis
    (``filt.p_cap``).
    """
    def outputs(state):
        lw = state.particles.log_w
        return _vp_common.frame_outputs(
            state, torch.exp(lw - torch.logsumexp(lw, dim=0)),
            map_w=torch.sigmoid)

    state = filt.init_state(torch.zeros(3, device=gen.device), d=3)
    return _vp_common.run_stream(filt, step_frame, state, frames, gen,
                                 input_cov, outputs, artificial_clutter,
                                 clutter_seed, **chunking)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--data", required=True)
    ap.add_argument("--messages", type=int, default=None,
                    help="process only the first N sensor messages")
    ap.add_argument("--logdir", default=None)
    ap.add_argument("--particles", type=int, default=None)
    ap.add_argument("--map-capacity", type=int, default=MAP_CAPACITY)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--hypotheses", type=int, default=None,
                    help="override XML maxNDataAssocHypotheses")
    ap.add_argument("--window", type=float, default=None,
                    help="override XML maxDataAssocLogLikelihoodDiff")
    ap.add_argument("--murty-lane-budget", type=int, default=-1,
                    help="max particle lanes running the full Murty "
                         "expansion per update (-1 = auto [n_particles], "
                         "0 = all lanes)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "twins)")
    _vp_common.add_ckpt_args(ap)
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    cfg = XmlConfig(args.cfg)
    n_msgs = args.messages if args.messages is not None else cfg.get(
        "filter.nMsgToProcess", 0, int)
    filt, input_cov, ack = build(
        cfg, map_capacity=args.map_capacity, n_particles=args.particles,
        hypotheses=args.hypotheses, window=args.window,
        murty_lane_budget=("auto" if args.murty_lane_budget < 0
                           else args.murty_lane_budget or None),
        device=dev)
    frames = vp_io.load(args.data, scale_ur=cfg.get("process.ur_scale", 1.0),
                        z_capacity=Z_CAPACITY, n_messages=n_msgs,
                        ackerman=ack)
    F = len(frames.t)
    mh = filt.cfg.max_hypotheses
    print(f"fastslam victoriapark: {F} lidar frames, "
          f"P={filt.cfg.n_particles}, hypotheses={mh}"
          f"{' (MH-FastSLAM)' if mh > 1 else ''}, device={dev}")
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
    # the final best particle's history through the resampling ancestry
    # (fastslam_VictoriaPark.cpp, as rbphdslam_VictoriaPark.cpp:631-660)
    rmse, dr_rmse = trajectory_rmse(frames, outs)
    print(f"trajectory RMSE vs GPS: {rmse:.2f} m  (dead reckoning: "
          f"{dr_rmse:.2f} m)")

    logdir = args.logdir or cfg.get("logging.logDirPrefix",
                                    "data/VictoriaPark/fastslam/results/",
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
