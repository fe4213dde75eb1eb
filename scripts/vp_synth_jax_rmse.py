"""The JAX package's RB-PHD Victoria Park app on the synthetic stream of
``rfs_slam_tpu_torch/io/vp_synth.py``: GPS RMSE per filter key, beside dead
reckoning's.  Sets the divergence bound that ``chip_smoke.py`` holds the
port's run to.

Runs on the CPU (``JAX_PLATFORMS=cpu``); P and the frame count are
arguments, since the full width (P=100, M=512) is slow there.  Prints one
JSON line per key and a summary line.

Usage::

    JAX_PLATFORMS=cpu python scripts/vp_synth_jax_rmse.py --out DIR \
        [--frames 2000] [--particles 16] [--keys 0 1 2]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from rfs_slam_tpu.apps import rbphdslam_victoriapark as app  # noqa: E402
from rfs_slam_tpu.io import logs  # noqa: E402
from rfs_slam_tpu.io import victoria_park as vp_io  # noqa: E402
from rfs_slam_tpu.io.xmlconfig import XmlConfig  # noqa: E402
from rfs_slam_tpu_torch.apps.rbphdslam_victoriapark import head  # noqa: E402
from rfs_slam_tpu_torch.io import vp_synth  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True, help="directory for the stream")
    ap.add_argument("--seed", type=int, default=0, help="stream seed")
    ap.add_argument("--frames", type=int, default=2000)
    ap.add_argument("--particles", type=int, default=16)
    ap.add_argument("--map-capacity", type=int, default=512)
    ap.add_argument("--keys", type=int, nargs="+", default=[0])
    ap.add_argument("--input-std", type=float, nargs=2, default=None,
                    help="write the stream with this speed and steering "
                         "noise std instead of vp_synth.INPUT_STD")
    args = ap.parse_args()

    if args.input_std:
        vp_synth.INPUT_STD = tuple(args.input_std)
    if not os.path.exists(os.path.join(args.out, "gps.dat")):
        vp_synth.write(args.out, args.seed)
    cfg = XmlConfig(vp_synth.write_config(os.path.join(args.out,
                                                       "config.xml")))
    filt, input_cov, ack = app.build(cfg, z_capacity=24,
                                     map_capacity=args.map_capacity,
                                     n_particles=args.particles)
    frames = head(vp_io.load(args.out, z_capacity=24, ackerman=ack),
                  args.frames)
    dr = app.gps_rmse(frames.t, frames.dr_pose, frames.gps)
    rmses = []
    for key in args.keys:
        t0 = time.time()
        _, outs, _ = app.run(filt, input_cov, frames, seed=key)
        poses, _, best, *_, parents = outs
        path = logs.ancestral_path(poses, parents, best[-1])
        rmse = app.gps_rmse(frames.t, path, frames.gps)
        rmses.append(rmse)
        print(json.dumps({"key": key, "frames": len(frames.t),
                          "particles": args.particles, "rmse_m": rmse,
                          "dead_reckoning_rmse_m": dr,
                          "wall_s": time.time() - t0}), flush=True)
    print(json.dumps({"summary": "jax cpu", "stream_seed": args.seed,
                      "input_std": list(vp_synth.INPUT_STD),
                      "frames": len(frames.t), "particles": args.particles,
                      "map_capacity": args.map_capacity, "keys": args.keys,
                      "rmse_m": rmses, "max_rmse_m": max(rmses),
                      "dead_reckoning_rmse_m": dr}))


if __name__ == "__main__":
    main()
