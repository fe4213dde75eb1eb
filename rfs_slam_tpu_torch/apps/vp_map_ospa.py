"""vp_map_ospa: OSPA / COLA between the final maps of two Victoria Park runs
(port of the JAX package's ``apps/vp_map_ospa.py``).

The dataset has no ground-truth tree map, so a map is scored against
another run's: the final best-particle maps of two runs (RB-PHD against
FastSLAM, or two seeds of one filter), as ``analysis2dsim`` scores the
simulations (analysis2dSim.cpp:182-247).  Reads the reference-format
``landmarkEst.dat`` (t, i, x, y, Sxx, Sxy, Syy, w), keeps the last
timestep's landmarks at or above the weight threshold, and prints OSPA
(with its localisation and cardinality parts) and COLA, from
``ops/ospa.py`` on the card unless ``--device cpu``.

Usage::

    python -m rfs_slam_tpu_torch.apps.vp_map_ospa A/landmarkEst.dat \\
        B/landmarkEst.dat [--cutoff 5.0] [--order 1] [--min-weight 0.75] \\
        [--log-odds-a] [--log-odds-b] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from rfs_slam_tpu_torch.apps.sim2d_common import device_for
from rfs_slam_tpu_torch.ops.ospa import ospa


def load_final_map(path: str, min_weight: float, log_odds: bool):
    """Final-timestep landmark positions with weight at or above the
    threshold; ``log_odds``: the weights are log-odds, thresholded as
    probabilities."""
    rows = np.loadtxt(path)
    if rows.ndim == 1:
        rows = rows[None]
    t_final = rows[:, 0].max()
    final = rows[np.abs(rows[:, 0] - t_final) < 1e-9]
    w = final[:, 7]
    if log_odds:
        w = 1.0 / (1.0 + np.exp(-w))
    return final[w >= min_weight, 2:4]


def map_error(a, b, cutoff: float, order: float, device: torch.device):
    """OSPA of the point sets ``a [Na, 2]`` and ``b [Nb, 2]`` (numpy) as
    floats: ``{"ospa", "loc", "card", "cola"}``."""
    def put(x):
        return torch.as_tensor(np.asarray(x, np.float32).reshape(-1, 2),
                               device=device)

    err = ospa(put(a), torch.ones(len(a), dtype=torch.bool, device=device),
               put(b), torch.ones(len(b), dtype=torch.bool, device=device),
               cutoff=cutoff, order=order)
    return {k: float(v) for k, v in err._asdict().items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("map_a")
    ap.add_argument("map_b")
    ap.add_argument("--cutoff", type=float, default=5.0,
                    help="OSPA cutoff c in metres (trees; the simulations "
                         "use 0.2 for point landmarks, analysis2dSim.cpp:238)")
    ap.add_argument("--order", type=float, default=1.0)
    ap.add_argument("--min-weight", type=float, default=0.75,
                    help="landmark weight threshold (analysis2dSim.cpp:182)")
    ap.add_argument("--log-odds-a", action="store_true",
                    help="map A's weights are log-odds")
    ap.add_argument("--log-odds-b", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "twins)")
    args = ap.parse_args(argv)

    dev = device_for(args.device)
    a = load_final_map(args.map_a, args.min_weight, args.log_odds_a)
    b = load_final_map(args.map_b, args.min_weight, args.log_odds_b)
    print(f"map A: {len(a)} landmarks (>= {args.min_weight}), "
          f"map B: {len(b)}")
    err = map_error(a, b, args.cutoff, args.order, dev)
    print(f"OSPA(c={args.cutoff}, p={args.order}): {err['ospa']:.3f} m "
          f"(loc sum {err['loc']:.2f}, card sum {err['card']:.2f})")
    print(f"COLA: {err['cola']:.3f}")
    return err


if __name__ == "__main__":
    main()
