"""The JAX package's FastSLAM / MH-FastSLAM Victoria Park app on the synthetic
stream of ``rfs_slam_tpu_torch/io/vp_synth.py``: GPS RMSE per filter key,
beside dead reckoning's.  Sets the divergence bounds that ``chip_smoke.py``
holds the port's VP FastSLAM runs to (PERF.md, section 6).

The stream is ``vp_synth``'s seed-0 stream without scans, its first
``--frames`` frames; the config is its ``config.xml`` (the Pd table; every
other key takes the app's defaults), wired by the JAX app's ``build`` at the
app's own width (P=200, M=512, Zc=24) unless told otherwise.  Runs on the
CPU (``JAX_PLATFORMS=cpu``).  Prints one JSON line per key, as each
finishes (with the best particle's alive landmarks at the last frame), and
a summary line.

``--bound N --lines FILE...`` runs nothing: it reads such JSON lines and
prints the bound of ``chip_smoke.py``'s rule for N seeds (the largest
median of the keys in consecutive groups of N, by key, rounded up at its
first significant digit) and how often a median of N of these keys drawn
at random (100,000 draws without replacement, generator seed 0) exceeds
it, or reaches dead reckoning's RMSE.  It also prints the rule's power:
how often such a median passes the rule (at most the bound and below dead
reckoning) when every key's RMSE is scaled by 1.5 and by 2, a port that
much worse than JAX.

Usage::

    JAX_PLATFORMS=cpu python scripts/vp_fastslam_jax_rmse.py --out DIR \
        [--frames 2000] [--hypotheses 3] [--particles 200] [--keys 0 1 2]
    python scripts/vp_fastslam_jax_rmse.py --bound 8 --lines KEYS.jsonl
"""

import argparse
import json
import math
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from rfs_slam_tpu.apps import fastslam_victoriapark as app  # noqa: E402
from rfs_slam_tpu.apps.rbphdslam_victoriapark import gps_rmse  # noqa: E402
from rfs_slam_tpu.io import logs  # noqa: E402
from rfs_slam_tpu.io import victoria_park as vp_io  # noqa: E402
from rfs_slam_tpu.io.xmlconfig import XmlConfig  # noqa: E402
from rfs_slam_tpu_torch.apps.rbphdslam_victoriapark import head  # noqa: E402
from rfs_slam_tpu_torch.io import vp_synth  # noqa: E402


def round_up_first_digit(x: float) -> float:
    """``x`` rounded up at its first significant digit (1.23 -> 2, 0.166
    -> 0.2)."""
    step = 10.0 ** math.floor(math.log10(x))
    return math.ceil(x / step - 1e-9) * step


def bound_report(paths, n: int) -> dict:
    """The rule's bound for ``n`` seeds from the keys' JSON lines in
    ``paths``, with the groups' medians and JAX's own failure rates."""
    rows = {}
    for path in paths:
        for line in open(path):
            d = json.loads(line)
            if "key" in d:
                rows[d["key"]] = d
    keys = sorted(rows)
    rmse = np.array([rows[k]["rmse_m"] for k in keys])
    dr = rows[keys[0]]["dead_reckoning_rmse_m"]
    groups = [keys[i:i + n] for i in range(0, len(keys) - n + 1, n)]
    medians = [float(np.median([rows[k]["rmse_m"] for k in g]))
               for g in groups]
    bound = round_up_first_digit(max(medians))
    rng = np.random.default_rng(0)
    picks = np.stack([rng.choice(len(rmse), n, replace=False)
                      for _ in range(100_000)])
    draws = np.median(rmse[picks], axis=1)
    passes = {f"{s:g}x": float(((s * draws <= bound)
                                & (s * draws < dr)).mean())
              for s in (1.5, 2.0)}
    return {"seeds": n, "keys": keys, "rmse_m": rmse.tolist(),
            "dead_reckoning_rmse_m": dr,
            "keys_above_dead_reckoning": int((rmse >= dr).sum()),
            "median_of_keys_m": float(np.median(rmse)),
            "groups": groups, "group_medians_m": medians,
            "bound_m": bound,
            "random_median_above_bound": float((draws > bound).mean()),
            "random_median_at_or_above_dead_reckoning": float(
                (draws >= dr).mean()),
            "scaled_random_median_passes": passes}


def run(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True, help="directory for the stream")
    ap.add_argument("--seed", type=int, default=0, help="stream seed")
    ap.add_argument("--frames", type=int, default=2000)
    ap.add_argument("--particles", type=int, default=200)
    ap.add_argument("--map-capacity", type=int, default=512)
    ap.add_argument("--hypotheses", type=int, default=1)
    ap.add_argument("--keys", type=int, nargs="+", default=[0])
    args = ap.parse_args(argv)

    if not os.path.exists(os.path.join(args.out, "gps.dat")):
        vp_synth.write(args.out, args.seed)
    cfg = XmlConfig(vp_synth.write_config(os.path.join(args.out,
                                                       "config.xml")))
    filt, input_cov, ack = app.build(cfg, z_capacity=24,
                                     map_capacity=args.map_capacity,
                                     n_particles=args.particles,
                                     hypotheses=args.hypotheses)
    frames = head(vp_io.load(args.out, z_capacity=24, ackerman=ack),
                  args.frames)
    dr = gps_rmse(frames.t, frames.dr_pose, frames.gps)
    rmses = []
    for key in args.keys:
        t0 = time.time()
        _, outs, _ = app.run(filt, input_cov, frames, seed=key)
        poses, _, best, *_, alive, parents = outs
        path = logs.ancestral_path(poses, parents, best[-1])
        rmse = gps_rmse(frames.t, path, frames.gps)
        rmses.append(rmse)
        print(json.dumps({"key": key, "frames": len(frames.t),
                          "particles": args.particles,
                          "hypotheses": args.hypotheses, "rmse_m": rmse,
                          "dead_reckoning_rmse_m": dr,
                          "best_alive_final": int(np.asarray(alive[-1]).sum()),
                          "map_capacity": args.map_capacity,
                          "wall_s": time.time() - t0}), flush=True)
    print(json.dumps({"summary": "jax cpu", "stream_seed": args.seed,
                      "frames": len(frames.t), "particles": args.particles,
                      "map_capacity": args.map_capacity,
                      "hypotheses": args.hypotheses, "keys": args.keys,
                      "rmse_m": rmses, "max_rmse_m": max(rmses),
                      "dead_reckoning_rmse_m": dr}))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bound", type=int, default=None,
                    help="print the rule's bound for this many seeds")
    ap.add_argument("--lines", nargs="+", default=[],
                    help="JSON-line files of earlier runs (with --bound)")
    args, rest = ap.parse_known_args()
    if args.bound:
        print(json.dumps(bound_report(args.lines, args.bound)))
        return
    run(rest)


if __name__ == "__main__":
    main()
