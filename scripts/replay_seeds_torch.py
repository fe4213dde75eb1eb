"""The port's ``native/bl_dump`` replay over generator seeds: the median
best-particle position error over steps >= 150 and steps/s, one JSON line
a seed.

The filter is the bench's (``bench.py:52-81``: P=200, M=128, Zc=40) on
the whole dump (3,000 steps, not cut), run through
``apps/sim2d_common.py::seed_errors`` one seed at a time, as
``chip_smoke.py`` replays seed 0.  ``scripts/replay_jax_err.py`` runs the
JAX package's filter on the same dump over ``PRNGKey`` keys; ``--ks``
holds the two sets of lines to a two-sided two-sample Kolmogorov-Smirnov
test (the rule of ROADMAP.md's Queue 3, row 1: p >= 0.05, the same
distribution).

Usage, from the repository root (on the card, or ``--device cpu``)::

    python3 scripts/replay_seeds_torch.py [--seeds 0 1 ... 15] \
        [--workers 4] [--steps 3000] [--device cpu]
    python3 scripts/replay_seeds_torch.py --ks PORT_LINES JAX_LINES

``--workers`` runs the seeds in that many processes (the card is idle
most of a step, so they share it); steps/s is then each process's own.
"""

import argparse
import concurrent.futures
import json
import multiprocessing
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rfs_slam_tpu_torch.apps import rbphdslam2dsim as app  # noqa: E402
from rfs_slam_tpu_torch.apps import sim2d_common as loop  # noqa: E402
from rfs_slam_tpu_torch.io import sim2d  # noqa: E402

BL_DUMP = os.path.join(ROOT, "native", "bl_dump")
GATE_M = 0.12          # bench.py:297, IDENTICAL_DATA_ANCHOR_M
KS_ALPHA = 0.05


def run_seeds(seeds, steps: int, device: str, workers: int) -> list:
    """One record a seed, in the order they finish."""
    with concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        futs = [ex.submit(_seed, s, steps, device) for s in seeds]
        out = []
        for f in concurrent.futures.as_completed(futs):
            out.append(f.result())
            print(json.dumps(out[-1]), flush=True)
    return out


_FILTER = {}


def _seed(seed: int, steps: int, device: str) -> dict:
    """One seed of the replay in this worker (the filter built once)."""
    torch.set_num_threads(1)    # many tiny ops: threads only contend
    dev = loop.device_for(device)
    if "filt" not in _FILTER:
        _FILTER["filt"] = app.build_filter(sim2d.Sim2DConfig(), dev)
        _FILTER["dump"] = app.load_bl_dump(BL_DUMP, steps)
    filt = _FILTER["filt"]
    gt, inputs = _FILTER["dump"]
    t0 = time.perf_counter()
    err, = loop.seed_errors(filt, inputs, gt[1:], sim2d.Sim2DConfig().dt,
                            [seed], dev)
    wall = time.perf_counter() - t0
    n = len(inputs[0])
    return {"seed": seed, "steps": n, "median_pose_err_m": err,
            "steps_per_s": n / wall, "device": str(dev)}


def read_errors(path: str, key: str) -> dict:
    """``{seed or key: error}`` from a file of JSON lines (the per-seed or
    per-key lines of either script; other lines are skipped)."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line.startswith("{"):
                continue
            rec = json.loads(line)
            if key in rec and isinstance(rec.get("median_pose_err_m"),
                                         float):
                out[rec[key]] = rec["median_pose_err_m"]
    return out


def ks(port: dict, jax_errs: dict) -> dict:
    """The rule: two-sided two-sample KS test of the port's seeds against
    JAX's keys; the row closes as "same distribution" when p >= 0.05."""
    from scipy import stats

    a = np.array([port[k] for k in sorted(port)])
    b = np.array([jax_errs[k] for k in sorted(jax_errs)])
    res = stats.ks_2samp(a, b, alternative="two-sided")
    return {"port_n": len(a), "jax_n": len(b),
            "port_median_m": float(np.median(a)),
            "jax_median_m": float(np.median(b)),
            "port_range_m": [float(a.min()), float(a.max())],
            "jax_range_m": [float(b.min()), float(b.max())],
            "port_share_within_gate": float(np.mean(a <= GATE_M)),
            "jax_share_within_gate": float(np.mean(b <= GATE_M)),
            "ks_statistic": float(res.statistic), "p_value": float(res.pvalue),
            "same_distribution": bool(res.pvalue >= KS_ALPHA)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(16)))
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ks", nargs=2, metavar=("PORT_LINES", "JAX_LINES"),
                    help="only the KS test of two files of JSON lines")
    args = ap.parse_args()
    if args.ks:
        print(json.dumps(ks(read_errors(args.ks[0], "seed"),
                            read_errors(args.ks[1], "key"))))
        return
    loop.device_for(args.device)        # raises where no card is
    t0 = time.perf_counter()
    recs = run_seeds(args.seeds, args.steps, args.device, args.workers)
    errs = [r["median_pose_err_m"] for r in sorted(recs,
                                                   key=lambda r: r["seed"])]
    print(json.dumps({"seeds": sorted(args.seeds), "median_pose_err_m": errs,
                      "median_m": float(np.median(errs)),
                      "all_finite": bool(np.isfinite(errs).all()),
                      "workers": args.workers,
                      "wall_s": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
