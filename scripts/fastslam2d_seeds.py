"""The port's FastSLAM 1.0 / MH-FastSLAM over several generator seeds: the
median best-particle position error over steps >= 150 per seed
(``apps/sim2d_common.py::seed_errors``, the loop ``chip_smoke.py`` holds
to its divergence bounds), beside dead reckoning's, on the data and config
of ``chip_smoke.py``'s FastSLAM phases (``sim2d.generate(traj_seed=1,
noise_seed=1)``, the stand-in XML of ``io/sim2d_xml.py``, the first
``--steps`` steps).  The spread it shows is the process's:
``scripts/fastslam2d_jax_err.py`` gives the JAX package's on the same data.

Usage, from the repository root (on the card, or ``--device cpu``)::

    python3 scripts/fastslam2d_seeds.py [--kind fastslam|mhfastslam] \
        [--steps 3000] [--seeds 0 1 2 3] [--device cpu]
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rfs_slam_tpu_torch.apps import fastslam2dsim as app  # noqa: E402
from rfs_slam_tpu_torch.apps import sim2d_common as loop  # noqa: E402
from rfs_slam_tpu_torch.io import sim2d, sim2d_xml  # noqa: E402
from rfs_slam_tpu_torch.io.xmlconfig import XmlConfig, load_sim2d  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kind", choices=("fastslam", "mhfastslam"),
                    default="fastslam")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    torch.set_num_threads(1)  # the CPU path is many tiny ops
    dev = loop.device_for(args.device)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    cfg = XmlConfig(sim2d_xml.write_config(
        os.path.join(ROOT, "build", f"{args.kind}2dSim.xml"), args.kind))
    sim_cfg = load_sim2d(cfg)
    data = sim2d.generate(sim_cfg, traj_seed=1, noise_seed=1)
    zc = max(data.z.shape[1], 4)
    filt = app.build_filter_from_xml(cfg, sim_cfg, z_capacity=zc, device=dev)
    inputs = loop.sim_inputs(data, steps=args.steps, z_capacity=zc)
    n = len(inputs[0])
    gt = data.gt_pose[1:n + 1]
    dr = loop.median_pose_error(data.dr_pose[1:n + 1], gt)
    t0 = time.perf_counter()
    errs = loop.seed_errors(filt, inputs, gt, sim_cfg.dt, args.seeds, dev)
    wall = time.perf_counter() - t0
    print(json.dumps({"kind": args.kind, "device": str(dev), "steps": n,
                      "seeds": args.seeds, "median_pose_err_m": errs,
                      "median_of_seeds_m": float(np.median(errs)),
                      "max_m": max(errs), "dead_reckoning_m": dr,
                      "steps_per_s": n * len(errs) / wall}))


if __name__ == "__main__":
    main()
