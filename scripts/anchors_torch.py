"""The four anchor cells of ``tests/test_batch_anchors.py`` on the port,
over generator seeds: the tail pose error of each run, and each cell's
median against its anchor bound.

Each cell is built as ``tests/test_batch_anchors.py:26-87`` builds it for
the JAX package: 500 steps of ``sim2d.generate(traj_seed=0,
noise_seed=1)`` at the cell's pd and clutter, Zc=56, P=48, the
ground-truth lock for steps <= 100, the tail error the mean best-particle
position error over the last quarter; the filters are those of
``tests/test_rbphd_filter.py:15`` and ``tests/test_fastslam.py:17``
(copied here, on the port's classes).  The rule (ROADMAP.md, Queue 3, row
2): every run finite, and each cell's median over the seeds at or below
its bound.  JAX's single-key values from the test's comment stand beside.

Usage, from the repository root (on the card, or ``--device cpu``)::

    python3 scripts/anchors_torch.py [--seeds 0 ... 7] [--workers 4] \
        [--cells rbphd_easy fastslam_hard] [--device cpu]

Prints one JSON line a run and one a cell; exits 1 when a cell misses.
"""

import argparse
import concurrent.futures
import dataclasses
import json
import multiprocessing
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rfs_slam_tpu_torch.apps import sim2d_common as loop  # noqa: E402
from rfs_slam_tpu_torch.filters.fastslam import (FastSLAMConfig,  # noqa: E402
                                                 FastSLAMFilter)
from rfs_slam_tpu_torch.filters.rbphd import RBPHDConfig, RBPHDFilter  # noqa: E402,E501
from rfs_slam_tpu_torch.io import sim2d  # noqa: E402
from rfs_slam_tpu_torch.ops.ekf import InnovationGates  # noqa: E402

STEPS = 500
N_PARTICLES = 48
Z_CAPACITY = 56


def build_rbphd(sim_cfg, device):
    """``tests/test_rbphd_filter.py::build_filter`` at P=48, Zc=56."""
    motion, lmk, meas = loop.sim_models(sim_cfg, device, 1.5, 10.0)
    cfg = RBPHDConfig(
        n_particles=N_PARTICLES, map_capacity=64, z_capacity=Z_CAPACITY,
        new_capacity=32, birth_capacity=8, eval_capacity=8, z_dp_max=6,
        birth_gaussian_weight=0.01, new_gaussian_md_threshold=3.0,
        eval_pt_min_weight=0.75, weighting_md_threshold=3.0,
        merge_threshold=0.5, merge_inflation=1.5, prune_threshold=0.01,
        min_updates_before_resample=2, ess_threshold=N_PARTICLES / 2)
    return RBPHDFilter(motion, lmk, meas, InnovationGates.range_bearing(
        range_t=1.0, bearing_t=0.2), cfg)


def build_fastslam(sim_cfg, device):
    """``tests/test_fastslam.py::build_filter`` at P=48, then
    ``test_batch_anchors.build_fastslam``'s Zc=56, NMZ=60."""
    motion, lmk, meas = loop.sim_models(sim_cfg, device, 1.5, 10.0)
    cfg = FastSLAMConfig(
        n_particles=N_PARTICLES, map_capacity=64, z_capacity=24,
        nmz_capacity=28, candidate_capacity=8, max_hypotheses=1,
        min_log_likelihood=-10.0, existence_prior=0.5, prune_threshold=-5.0,
        min_updates_before_resample=2, ess_threshold=N_PARTICLES / 2.0)
    cfg = dataclasses.replace(cfg, z_capacity=Z_CAPACITY,
                              nmz_capacity=Z_CAPACITY + 4)
    return FastSLAMFilter(motion, lmk, meas, InnovationGates.range_bearing(
        range_t=1.0, bearing_t=0.2), cfg)


# name: (builder, pd, clutter, bound m, JAX's tail error m at PRNGKey(0))
CELLS = {
    "rbphd_easy": (build_rbphd, 0.99, 1e-4, 0.30, 0.125),
    "rbphd_hard": (build_rbphd, 0.75, 1e-2, 0.15, 0.058),
    "rbphd_corner": (build_rbphd, 0.50, 1e-1, 0.30, 0.113),
    "fastslam_hard": (build_fastslam, 0.50, 1e-2, 0.06, 0.011),
}


def tail_error(best: np.ndarray, gt: np.ndarray) -> float:
    """The mean position error over the last quarter of the steps
    (``run_cell``'s ``k0 = 3 (T - 1) // 4``)."""
    err = np.linalg.norm(best[:, :2] - gt[:, :2], axis=1)
    return float(np.mean(err[(3 * len(err)) // 4:]))


def run_cell(name: str, seed: int, device: str) -> dict:
    """One run of a cell with generator ``seed``."""
    torch.set_num_threads(1)    # many tiny ops: threads only contend
    dev = loop.device_for(device)
    builder, pd, clutter = CELLS[name][:3]
    sim_cfg = sim2d.Sim2DConfig(timesteps=STEPS, pd=pd, clutter=clutter)
    data = sim2d.generate(sim_cfg, traj_seed=0, noise_seed=1,
                          z_capacity=Z_CAPACITY)
    filt = builder(sim_cfg, dev)
    t0 = time.perf_counter()
    _, best = loop.run(filt, loop.sim_inputs(data, z_capacity=Z_CAPACITY),
                       torch.Generator(device=dev).manual_seed(seed),
                       sim_cfg.dt)
    wall = time.perf_counter() - t0
    return {"cell": name, "seed": seed,
            "tail_err_m": tail_error(best, data.gt_pose[1:]),
            "finite": bool(np.isfinite(best).all()),
            "steps_per_s": (STEPS - 1) / wall, "device": str(dev)}


def verdict(name: str, runs: list) -> dict:
    """The rule on one cell's runs."""
    errs = [r["tail_err_m"] for r in sorted(runs, key=lambda r: r["seed"])]
    bound, jax_err = CELLS[name][3:]
    med = float(np.median(errs))
    finite = all(r["finite"] for r in runs)
    return {"cell": name, "seeds": sorted(r["seed"] for r in runs),
            "tail_err_m": errs, "median_m": med, "bound_m": bound,
            "jax_key0_m": jax_err, "all_finite": finite,
            "ok": finite and med <= bound}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", nargs="+", choices=list(CELLS),
                    default=list(CELLS))
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(8)))
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    loop.device_for(args.device)        # raises where no card is
    runs = {c: [] for c in args.cells}
    with concurrent.futures.ProcessPoolExecutor(
            args.workers, mp_context=multiprocessing.get_context("spawn")
    ) as ex:
        futs = [ex.submit(run_cell, c, s, args.device)
                for c in args.cells for s in args.seeds]
        for f in concurrent.futures.as_completed(futs):
            rec = f.result()
            runs[rec["cell"]].append(rec)
            print(json.dumps(rec), flush=True)
    ok = True
    for c in args.cells:
        v = verdict(c, runs[c])
        ok &= v["ok"]
        print(json.dumps(v), flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
