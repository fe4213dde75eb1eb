"""batchsim — parameter-sweep regression harness (port of the JAX package's
``apps/batchsim.py``).

The reference's ``scripts/batchSim/batchSim_*.bash``
(batchSim_rbphdslam.bash:9-40): sweep P_D x clutter x seeds on the 2-D sim,
run the filter per combination, and append the final pose and map errors
to a results file (the reference's de-facto regression suite).  Each
combination runs on the card unless ``--device cpu``.

Usage (the reference's XML is not in the repository;
``io/sim2d_xml.py`` writes a stand-in)::

    python -m rfs_slam_tpu_torch.apps.batchsim --cfg CFG.xml \\
        --filter rbphd --pd 0.99 0.9 0.75 --clutter 1e-4 1e-3 \\
        --seeds 3 --steps 500 --out results_rbphd.dat [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from rfs_slam_tpu_torch.apps import analysis2dsim
from rfs_slam_tpu_torch.apps import fastslam2dsim, rbphdslam2dsim
from rfs_slam_tpu_torch.apps.sim2d_common import (
    device_for, run_logged, sim_inputs)
from rfs_slam_tpu_torch.io import sim2d
from rfs_slam_tpu_torch.io.xmlconfig import XmlConfig, load_sim2d


def final_map_cola(filter_kind, data, sim_cfg, gm_mean, gm_w, gm_alive,
                   w_threshold=0.75, cutoff=0.2, order=1.0):
    """COLA map error of the final best-particle map estimate against the
    groundtruth landmarks observable by then (the reference's mapError
    column, batchSim_rbphdslam.bash:36 via analysis2dSim.cpp:182-247; c=0.2,
    p=1, estimates with w >= 0.75).  FastSLAM's log-odds existence weights
    are thresholded at the same 0.75 on the probability scale."""
    w = np.asarray(gm_w[-1], np.float64)
    if filter_kind != "rbphd":
        w = 1.0 / (1.0 + np.exp(-w))          # log-odds -> probability
    keep = np.asarray(gm_alive[-1]) & (w >= w_threshold)
    est = np.asarray(gm_mean[-1])[keep]
    t_end = (sim_cfg.timesteps - 1) * sim_cfg.dt
    obs = (data.lmk_first_obs >= 0) & (data.lmk_first_obs <= t_end)
    return float(analysis2dsim.cola_error(est, data.landmarks[obs],
                                          cutoff=cutoff, order=order))


def run_one(filter_kind, cfg, sim_cfg, traj_seed, noise_seed, z_capacity,
            n_particles, device: torch.device | None = None):
    """One sweep cell: ``(mean error over the last quarter of the steps,
    final error, final map COLA, wall seconds)``.  On the card unless
    ``device`` is the CPU; raises where there is no card."""
    device = device_for(device)
    try:
        data = sim2d.generate(sim_cfg, traj_seed=traj_seed,
                              noise_seed=noise_seed, z_capacity=z_capacity)
    except ValueError:
        # a high-clutter cell overflows the capacity: take its natural max,
        # in multiples of 16
        probe = sim2d.generate(sim_cfg, traj_seed=traj_seed,
                               noise_seed=noise_seed, z_capacity=None)
        z_capacity = max(z_capacity, -(-probe.z.shape[1] // 16) * 16)
        data = sim2d.generate(sim_cfg, traj_seed=traj_seed,
                              noise_seed=noise_seed, z_capacity=z_capacity)
    app = rbphdslam2dsim if filter_kind == "rbphd" else fastslam2dsim
    filt = app.build_filter_from_xml(cfg, sim_cfg, z_capacity=z_capacity,
                                     n_particles=n_particles, device=device)
    t0 = time.perf_counter()
    _, outs = run_logged(filt, sim_inputs(data), torch.Generator(
        device=device).manual_seed(0), sim_cfg.dt)
    wall = time.perf_counter() - t0
    T = sim_cfg.timesteps
    # the last quarter's errors (the reference batch scripts record the tail)
    k0 = (3 * (T - 1)) // 4
    best_pose = outs["pose"][np.arange(T - 1), outs["best"]]
    err = np.linalg.norm(best_pose[k0:, :2] - data.gt_pose[1 + k0:, :2],
                         axis=1)
    map_err = final_map_cola(filter_kind, data, sim_cfg, outs["mean"],
                             outs["gm_w"], outs["alive"])
    return float(np.mean(err)), float(err[-1]), map_err, wall


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--filter", choices=["rbphd", "fastslam"], default="rbphd")
    ap.add_argument("--pd", type=float, nargs="+",
                    default=[0.99, 0.95, 0.9, 0.75, 0.5])
    ap.add_argument("--clutter", type=float, nargs="+",
                    default=[1e-4, 1e-3, 1e-2])
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--particles", type=int, default=None)
    ap.add_argument("--out", default="batchResults.dat")
    ap.add_argument("--zc", type=int, default=48,
                    help="measurement capacity (raised per cell when a "
                         "high-clutter sim overflows it)")
    ap.add_argument("--seed-offset", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "twins)")
    args = ap.parse_args(argv)

    dev = device_for(args.device)
    cfg = XmlConfig(args.cfg)
    base = load_sim2d(cfg)
    if args.steps:
        base = dataclasses.replace(base, timesteps=args.steps)

    n = 0
    with open(args.out, "a") as f:
        f.write(f"# filter={args.filter} cfg={args.cfg} "
                f"steps={base.timesteps} device={dev}\n")
        f.write("# pd  clutter  seed  meanTailErr  finalErr  mapCola  wall_s\n")
        for pd in args.pd:
            for clutter in args.clutter:
                sim_cfg = dataclasses.replace(base, pd=pd, clutter=clutter)
                for seed in range(args.seed_offset,
                                  args.seed_offset + args.seeds):
                    t0 = time.time()
                    mean_err, final_err, map_err, wall = run_one(
                        args.filter, cfg, sim_cfg, traj_seed=seed,
                        noise_seed=seed + 1, z_capacity=args.zc,
                        n_particles=args.particles, device=dev)
                    f.write(f"{pd:.4f}  {clutter:.6g}  {seed}  "
                            f"{mean_err:.6f}  {final_err:.6f}  "
                            f"{map_err:.6f}  {wall:.2f}\n")
                    f.flush()
                    n += 1
                    print(f"[{n}] pd={pd} clutter={clutter} seed={seed}: "
                          f"tail err {mean_err:.3f} m, map COLA "
                          f"{map_err:.2f} ({time.time() - t0:.1f}s)")
    print(f"results -> {args.out}")


if __name__ == "__main__":
    main()
