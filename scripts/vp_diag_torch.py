"""Victoria Park RB-PHD filter health by segment, on the port (the
counterpart of the JAX package's ``scripts/vp_diag.py``).

Runs the port's RB-PHD Victoria Park app (``apps/rbphdslam_victoriapark
.run``, Zc=24, M=512, generator seed 0) and prints, for each tenth of the
frames, the mean effective sample size, the best particle's alive map
size, its strong landmarks (w >= 0.75, the importance weighting's eval
points), its map weight sum, the share of frames that resampled, and the
GPS RMSE of the segment of the final best particle's ancestral path; then
the total RMSE beside dead reckoning's (:func:`segment_health`).

The stream is the synthetic one of ``io/vp_synth.py`` (seed 0, the first
``--frames`` frames, written under ``build/``) unless ``--data DIR --cfg
XML`` name the Victoria Park log and its config, which the repository
does not hold yet.

Usage, from the repository root (on the card, or ``--device cpu``)::

    python3 scripts/vp_diag_torch.py [--frames 2000] [--particles 100] \
        [--device cpu] [--data DIR --cfg XML [--messages N]]
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from rfs_slam_tpu_torch.apps.rbphdslam_victoriapark import gps_rmse  # noqa: E402,E501
from rfs_slam_tpu_torch.io import logs  # noqa: E402

STRONG_W = 0.75


def segment_health(outs: dict, t: np.ndarray, gps: np.ndarray,
                   segments: int = 10) -> list[dict]:
    """The JAX script's table from a run's outputs (``outs``: the app's
    ``w [F, P]``, ``gm_w``/``alive [F, M]``, ``parent [F, P]``, ``pose``,
    ``best``): per segment of ``max(F // segments, 1)`` frames the means
    of the ESS ``1 / sum w^2``, the alive map size, the strong landmarks,
    the map weight sum and the resampled frames (a parent not itself), and
    the segment's GPS RMSE of the ancestral path."""
    w, gm_w, alive, parents = (outs["w"], outs["gm_w"], outs["alive"],
                               outs["parent"])
    F = len(t)
    ess = 1.0 / np.maximum(np.sum(w ** 2, axis=1), 1e-30)
    n_alive = alive.sum(axis=1)
    n_strong = ((gm_w >= STRONG_W) & alive).sum(axis=1)
    total_w = np.where(alive, gm_w, 0).sum(axis=1)
    resampled = (parents != np.arange(parents.shape[1])[None]).any(axis=1)
    path = logs.ancestral_path(outs["pose"], parents, outs["best"][-1])
    C = max(F // segments, 1)
    rows = []
    for s in range(0, F, C):
        sl = slice(s, min(s + C, F))
        rows.append({"start": s, "frames": sl.stop - s,
                     "ess": float(ess[sl].mean()),
                     "map_alive": float(n_alive[sl].mean()),
                     "strong": float(n_strong[sl].mean()),
                     "sum_w": float(total_w[sl].mean()),
                     "resampled": float(resampled[sl].mean()),
                     "rmse_gps_m": gps_rmse(t[sl], path[sl], gps)})
    return rows


def main(argv=None):
    import torch

    from rfs_slam_tpu_torch.apps import _vp_common
    from rfs_slam_tpu_torch.apps import rbphdslam_victoriapark as app
    from rfs_slam_tpu_torch.apps.sim2d_common import device_for
    from rfs_slam_tpu_torch.io import victoria_park as vp_io
    from rfs_slam_tpu_torch.io.xmlconfig import XmlConfig

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=2000,
                    help="frames of the synthetic stream")
    ap.add_argument("--particles", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--data", default=None,
                    help="the Victoria Park log (default: synthetic)")
    ap.add_argument("--cfg", default=None, help="its XML config")
    ap.add_argument("--messages", type=int, default=0,
                    help="the log's first N sensor messages")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    dev = device_for(args.device)
    data, cfg_path = _vp_common.stream_paths(
        args.data, args.cfg, args.frames, 0, os.path.join(ROOT, "build"))
    cfg = XmlConfig(cfg_path)
    filt, input_cov, ack = app.build(cfg, z_capacity=24, map_capacity=512,
                                     n_particles=args.particles, device=dev)
    frames = vp_io.load(data, scale_ur=cfg.get("process.ur_scale", 1.0),
                        z_capacity=24, n_messages=args.messages,
                        ackerman=ack)
    # a stream with one fix (or none) loads it as a row (or nothing)
    gps = (frames.gps if frames.gps.ndim == 2
           else frames.gps.reshape(-1, 3))
    t0 = time.perf_counter()
    _, outs = app.run(filt, input_cov, frames,
                      torch.Generator(device=dev).manual_seed(0),
                      progress=False)
    wall = time.perf_counter() - t0
    rows = segment_health(outs, frames.t, gps)
    print(" seg   frames       ESS  map_alive  strong(w>=.75)  sum_w  "
          "resamp  rmse_gps")
    for r in rows:
        print(f"{r['start']:5d} {r['frames']:8d} {r['ess']:9.1f} "
              f"{r['map_alive']:10.1f} {r['strong']:15.1f} "
              f"{r['sum_w']:6.1f} {r['resampled']:7.2f} "
              f"{r['rmse_gps_m']:9.2f}")
    path = logs.ancestral_path(outs["pose"], outs["parent"],
                               outs["best"][-1])
    rec = {"frames": len(frames.t), "particles": args.particles,
           "segments": rows, "stream": data, "device": str(dev),
           "rmse_m": gps_rmse(frames.t, path, gps),
           "dead_reckoning_rmse_m": gps_rmse(frames.t, frames.dr_pose,
                                             gps),
           "frames_per_s": len(frames.t) / wall}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
