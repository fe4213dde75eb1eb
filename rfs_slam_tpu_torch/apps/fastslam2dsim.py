"""FastSLAM 1.0 / MH-FastSLAM on the 2-D range-bearing simulation (port of
the JAX package's ``apps/fastslam2dsim.py``; the reference executable is
fastslam2dSim.cpp).  MH-FastSLAM is selected by
``<maxNDataAssocHypotheses>`` in the XML, as in the reference
(cfg/mhfastslam2dSim.xml differs from cfg/fastslam2dSim.xml only in that
key).

The step loop and the logs are ``apps/sim2d_common.py``'s (the filters
share predict and update): one Python step per timestep on the generator's
device, nothing read back until the end.

Usage (the reference's XML is not in the repository;
``io/sim2d_xml.py`` writes a stand-in)::

    python -m rfs_slam_tpu_torch.apps.fastslam2dsim --cfg CFG.xml \\
        [--trajectory N] [--seed N] [--steps N] [--logdir DIR] \\
        [--particles N] [--murty-cap N] [--murty-lane-budget N] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from rfs_slam_tpu_torch.apps.sim2d_common import (
    device_for, run_logged, sim_inputs, write_logs, xml_models)
from rfs_slam_tpu_torch.filters.fastslam import FastSLAMConfig, FastSLAMFilter
from rfs_slam_tpu_torch.io import sim2d
from rfs_slam_tpu_torch.io.xmlconfig import XmlConfig, load_sim2d


def build_filter_from_xml(cfg: XmlConfig, sim_cfg: sim2d.Sim2DConfig,
                          z_capacity: int, n_particles: int | None = None,
                          murty_child_cap: int | None = 6,
                          murty_lane_budget: int | str | None = "auto",
                          device: torch.device | None = None
                          ) -> FastSLAMFilter:
    """Wiring per fastslam2dSim.cpp:452-482 (the JAX app's keys and
    defaults), tensors on ``device``: the card unless the caller asks for
    the CPU.  ``murty_lane_budget="auto"`` is ``n_particles`` (a third of
    the grown particle axis); None runs every lane's full expansion."""
    device = device_for(device)
    n_particles = n_particles or cfg.get("filter.nParticles", 200, int)
    if murty_lane_budget == "auto":
        murty_lane_budget = n_particles
    fcfg = FastSLAMConfig(
        n_particles=n_particles, map_capacity=128, z_capacity=z_capacity,
        nmz_capacity=max(z_capacity + 4, 32), candidate_capacity=16,
        max_hypotheses=cfg.get("filter.update.maxNDataAssocHypotheses", 1,
                               int),
        murty_child_cap=murty_child_cap,
        murty_lane_budget=murty_lane_budget,
        max_da_loglik_diff=cfg.get(
            "filter.update.maxDataAssocLogLikelihoodDiff", 3.0),
        min_log_likelihood=cfg.get(
            "filter.weighting.minLogMeasurementLikelihood", -10.0),
        existence_prior=0.5,
        prune_threshold=cfg.get("filter.prune.threshold", -5.0),
        min_updates_before_resample=cfg.get("filter.resampling.minTimesteps",
                                            1, int),
        ess_threshold=cfg.get("filter.resampling.effNParticle",
                              float(n_particles)))
    return FastSLAMFilter(*xml_models(cfg, sim_cfg, device), fcfg)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--trajectory", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--logdir", default=None)
    ap.add_argument("--particles", type=int, default=None)
    ap.add_argument("--murty-cap", type=int, default=6,
                    help="murty child_cap (0 = uncapped exact solver)")
    ap.add_argument("--murty-lane-budget", type=int, default=-1,
                    help="max particle lanes running the full Murty "
                         "expansion per update (-1 = auto [n_particles], "
                         "0 = all lanes)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "twins)")
    args = ap.parse_args(argv)

    dev = device_for(args.device)
    cfg = XmlConfig(args.cfg)
    sim_cfg = load_sim2d(cfg)
    if args.steps:
        sim_cfg = dataclasses.replace(sim_cfg, timesteps=args.steps)
    data = sim2d.generate(sim_cfg, traj_seed=args.trajectory,
                          noise_seed=args.seed)
    zc = data.z.shape[1]
    lane_budget = ("auto" if args.murty_lane_budget < 0
                   else args.murty_lane_budget or None)
    filt = build_filter_from_xml(cfg, sim_cfg, z_capacity=max(zc, 4),
                                 n_particles=args.particles,
                                 murty_child_cap=args.murty_cap or None,
                                 murty_lane_budget=lane_budget, device=dev)
    print(f"fastslam2dsim: T={sim_cfg.timesteps} P={filt.cfg.n_particles} "
          f"H={filt.cfg.max_hypotheses} Zmax={zc} device={dev}")
    t0 = time.perf_counter()
    # the filter's generator is seeded 0, as the JAX app's key
    _, outs = run_logged(filt, sim_inputs(data, z_capacity=max(zc, 4)),
                         torch.Generator(device=dev).manual_seed(0),
                         sim_cfg.dt)
    wall = time.perf_counter() - t0
    T = sim_cfg.timesteps
    print(f"done: {T - 1} steps in {wall:.2f}s ({(T - 1) / wall:.1f} "
          f"timesteps/s)")
    logdir = args.logdir or cfg.get("logging.logDirPrefix", "data/fastslam",
                                    str)
    if cfg.get("logging.logResultsToFile", 0, int) or args.logdir:
        err = write_logs(logdir, args.cfg, data, sim_cfg.dt, outs)
        print(f"logs -> {logdir}; median best-particle pose err "
              f"{err:.4f} m")


if __name__ == "__main__":
    main()
