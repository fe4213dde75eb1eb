"""RB-PHD SLAM on the 2-D range-bearing simulation (port of the JAX
package's ``apps/rbphdslam2dsim.py``; the reference executable is
rbphdslam2dSim.cpp).

``build_filter`` wires the configuration of the JAX package's ``bench.py``
(P=200 particles, map capacity 128, measurement capacity 40, the
rbphdslam2dSim.xml defaults); ``build_filter_from_xml`` wires a
reference-format XML config, with the JAX app's keys and defaults.  The
step loop and the logs are ``apps/sim2d_common.py``'s.

Usage (the reference's XML is not in the repository;
``io/sim2d_xml.py`` writes a stand-in)::

    python -m rfs_slam_tpu_torch.apps.rbphdslam2dsim --cfg CFG.xml \
        [--trajectory N] [--seed N] [--steps N] [--logdir DIR] \
        [--particles N] [--device cpu] [--profile]

``--profile`` times the filter's seven phases on step 1 first
(``utils/timing.py``) and, with logs, writes them to ``timing.dat``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from rfs_slam_tpu_torch.apps.sim2d_common import (
    GT_LOCK_STEPS, device_for, run_logged, sim_inputs, sim_models,
    write_logs, xml_models)
from rfs_slam_tpu_torch.filters.rbphd import RBPHDConfig, RBPHDFilter
from rfs_slam_tpu_torch.io import logs, sim2d
from rfs_slam_tpu_torch.io.xmlconfig import XmlConfig, load_sim2d
from rfs_slam_tpu_torch.ops.ekf import InnovationGates
from rfs_slam_tpu_torch.utils.timing import profile_phases

N_PARTICLES = 200
T = 3000
Z_CAPACITY = 40
MAP_CAPACITY = 128


def build_filter(sim_cfg: sim2d.Sim2DConfig, device: torch.device,
                 n_particles: int = N_PARTICLES,
                 map_capacity: int | None = None) -> RBPHDFilter:
    """The filter of bench.py:52-81 on ``device`` (with ``map_capacity``,
    maps of that many slots in place of its 128)."""
    motion, lmk, meas = sim_models(sim_cfg, device, 1.5, 10.0)
    gates = InnovationGates.range_bearing(range_t=1.0, bearing_t=0.2)
    cfg = RBPHDConfig(
        n_particles=n_particles, map_capacity=map_capacity or MAP_CAPACITY,
        z_capacity=Z_CAPACITY, new_capacity=48, new_per_z=8,
        birth_capacity=16, eval_capacity=15, z_dp_max=10,
        birth_gaussian_weight=0.01, new_gaussian_md_threshold=3.0,
        eval_pt_min_weight=0.75, weighting_md_threshold=3.0,
        merge_threshold=0.5, merge_inflation=1.5, prune_threshold=0.01,
        min_updates_before_resample=2, ess_threshold=100.0,
    )
    return RBPHDFilter(motion, lmk, meas, gates, cfg)


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


def build_filter_from_xml(cfg: XmlConfig, sim_cfg: sim2d.Sim2DConfig,
                          z_capacity: int, map_capacity: int = 256,
                          n_particles: int | None = None,
                          device: torch.device | None = None) -> RBPHDFilter:
    """Filter wiring per rbphdslam2dSim.cpp:444-492 (the JAX app's keys and
    defaults), tensors on ``device``: the card unless the caller asks for
    the CPU."""
    device = device_for(device)
    n_particles = n_particles or cfg.get("filter.nParticles", 200, int)
    fcfg = RBPHDConfig(
        n_particles=n_particles, map_capacity=map_capacity,
        z_capacity=z_capacity, new_capacity=64, birth_capacity=16,
        eval_capacity=cfg.get("filter.weighting.nEvalPt", 15, int),
        z_dp_max=10,
        birth_gaussian_weight=cfg.get("filter.predict.birthGaussianWeight",
                                      0.01),
        new_gaussian_md_threshold=cfg.get(
            "filter.update.GaussianCreateInnovMDThreshold", 0.2),
        eval_pt_min_weight=cfg.get("filter.weighting.minWeight", 0.75),
        weighting_md_threshold=cfg.get("filter.weighting.threshold", 3.0),
        merge_threshold=cfg.get("filter.merge.threshold", 0.5),
        merge_inflation=cfg.get("filter.merge.covInflationFactor", 1.0),
        prune_threshold=cfg.get("filter.prune.threshold", 0.01),
        min_updates_before_resample=cfg.get("filter.resampling.minTimesteps",
                                            1, int),
        ess_threshold=cfg.get("filter.resampling.effNParticle",
                              float(n_particles)),
        use_cluster_process=cfg.get("filter.weighting.useClusterProcess",
                                    False, bool))
    return RBPHDFilter(*xml_models(cfg, sim_cfg, device), fcfg)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--trajectory", type=int, default=0,
                    help="trajectory random seed (reference --trajectory)")
    ap.add_argument("--seed", type=int, default=0,
                    help="measurement noise seed (reference --seed)")
    ap.add_argument("--steps", type=int, default=None,
                    help="override timesteps")
    ap.add_argument("--logdir", default=None)
    ap.add_argument("--particles", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "twins)")
    ap.add_argument("--profile", action="store_true",
                    help="per-phase timing report (timing.dat), host and "
                         "device times")
    args = ap.parse_args(argv)

    dev = device_for(args.device)
    cfg = XmlConfig(args.cfg)
    sim_cfg = load_sim2d(cfg)
    if args.steps:
        sim_cfg = dataclasses.replace(sim_cfg, timesteps=args.steps)
    data = sim2d.generate(sim_cfg, traj_seed=args.trajectory,
                          noise_seed=args.seed, z_capacity=None)
    zc = data.z.shape[1]
    filt = build_filter_from_xml(cfg, sim_cfg, z_capacity=max(zc, 4),
                                 n_particles=args.particles, device=dev)
    print(f"rbphdslam2dsim: T={sim_cfg.timesteps} P={filt.cfg.n_particles} "
          f"L={sim_cfg.n_landmarks} Zmax={zc} device={dev}")
    if args.profile:
        # the TimingInfo report (RBPHDFilter.hpp:1219-1232) on step 1
        def put(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        timer = profile_phases(
            filt, filt.init_state(torch.zeros(3, device=dev)),
            put(data.odometry[1]), sim_cfg.dt, put(data.z[1]),
            put(data.z_mask[1], torch.bool),
            torch.Generator(device=dev).manual_seed(args.seed))
        print(timer.table())
    t0 = time.perf_counter()
    # the filter's generator is seeded 0, as the JAX app's key
    _, outs = run_logged(filt, sim_inputs(data, z_capacity=max(zc, 4)),
                         torch.Generator(device=dev).manual_seed(0),
                         sim_cfg.dt)
    wall = time.perf_counter() - t0
    T = sim_cfg.timesteps
    print(f"done: {T - 1} steps in {wall:.2f}s ({(T - 1) / wall:.1f} "
          f"timesteps/s)")
    logdir = args.logdir or cfg.get("logging.logDirPrefix", "data/rbphdslam",
                                    str)
    if cfg.get("logging.logResultsToFile", 0, int) or args.logdir:
        err = write_logs(logdir, args.cfg, data, sim_cfg.dt, outs)
        if args.profile:
            logs.write_timing(logdir, timer.report())
        print(f"logs -> {logdir}; median best-particle pose err "
              f"{err:.4f} m")


if __name__ == "__main__":
    main()
