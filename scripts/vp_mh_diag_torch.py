"""Score a Victoria Park MH-FastSLAM run of the port from its snapshot
outputs (the counterpart of the JAX package's ``scripts/vp_mh_diag.py``).

It reads the per-chunk outputs that the run saved beside its snapshots
(``outs_*.npz`` in ``--ckpt-dir``, ``apps/_vp_common._load_out_chunks``),
rebuilds the final best particle's ancestral path and prints the JSON of
:func:`divergence_score`: the RMSE against the GPS fixes over the whole
stream (from ``--from-frame``) and by quartile, the per-fix error
percentiles, and the first fix whose error passes 10 m.

The stream is the synthetic one of ``io/vp_synth.py`` (seed 0, the first
``--frames`` frames, written under ``build/``) unless ``--data DIR --cfg
XML`` name the Victoria Park log and its config, which the repository
does not hold yet; the run must be of the same stream
(``scripts/vp_cap_count_torch.py`` makes one in its default directory).

Usage, from the repository root::

    python3 scripts/vp_mh_diag_torch.py [--ckpt-dir build/vp_mh_ckpt] \
        [--frames 1000] [--from-frame N] [--data DIR --cfg XML]
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from rfs_slam_tpu_torch.apps.rbphdslam_victoriapark import gps_rmse  # noqa: E402,E501

DIVERGED_M = 10.0


def divergence_score(t: np.ndarray, best_path: np.ndarray, gps: np.ndarray,
                     from_frame: int = 0) -> dict:
    """The JAX script's arithmetic on the best particle's path
    ``[F, 3]`` at frame times ``t`` against the fixes ``gps [G, 3]`` (t,
    x, y): the RMSE from ``from_frame``, by quartile of the frames from
    there, and each fix matched to its nearest frame (within 0.5 s) for
    the per-fix error percentiles and the first error over 10 m."""
    F = len(t)
    sl = slice(from_frame, F)
    rec = {"frames": F, "from_frame": from_frame,
           "rmse_m": gps_rmse(t[sl], best_path[sl], gps)}
    q = max((F - from_frame) // 4, 1)
    quart = []
    for k in range(4):
        s = from_frame + k * q
        e = from_frame + (k + 1) * q if k < 3 else F
        quart.append({"frames": [s, e], "rmse_m": (
            gps_rmse(t[s:e], best_path[s:e], gps) if e > s
            else float("nan"))})      # fewer than four frames
    rec["quartiles"] = quart
    gi = np.clip(np.searchsorted(t, gps[:, 0]), 0, F - 1)
    gi0 = np.clip(gi - 1, 0, F - 1)
    gi = np.where(np.abs(t[gi0] - gps[:, 0]) < np.abs(t[gi] - gps[:, 0]),
                  gi0, gi)
    keep = np.abs(t[gi] - gps[:, 0]) <= 0.5
    err = np.linalg.norm(best_path[gi][:, :2] - gps[:, 1:3], axis=1)
    err, gi, fix_t = err[keep], gi[keep], gps[keep, 0]
    if from_frame:
        m = gi >= from_frame
        err, gi, fix_t = err[m], gi[m], fix_t[m]
    rec["fixes"] = int(err.size)
    if err.size:
        rec["per_fix_m"] = {"p50": float(np.percentile(err, 50)),
                            "p90": float(np.percentile(err, 90)),
                            "max": float(err.max())}
    over = np.nonzero(err > DIVERGED_M)[0]
    rec["fixes_over_10m"] = int(over.size)
    rec["first_over_10m"] = (None if not over.size else {
        "t": float(fix_t[over[0]]), "frame": int(gi[over[0]]),
        "err_m": float(err[over[0]])})
    return rec


def main(argv=None):
    import torch

    from rfs_slam_tpu_torch.apps import _vp_common
    from rfs_slam_tpu_torch.apps import fastslam_victoriapark as fs_vp
    from rfs_slam_tpu_torch.apps.rbphdslam_victoriapark import vp_models
    from rfs_slam_tpu_torch.io import logs
    from rfs_slam_tpu_torch.io import victoria_park as vp_io
    from rfs_slam_tpu_torch.io.xmlconfig import XmlConfig

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(ROOT, "build", "vp_mh_ckpt"))
    ap.add_argument("--frames", type=int, default=1000,
                    help="frames of the synthetic stream")
    ap.add_argument("--from-frame", type=int, default=0)
    ap.add_argument("--data", default=None,
                    help="the Victoria Park log (default: synthetic)")
    ap.add_argument("--cfg", default=None, help="its XML config")
    ap.add_argument("--messages", type=int, default=0,
                    help="the log's first N sensor messages")
    args = ap.parse_args(argv)
    data, cfg_path = _vp_common.stream_paths(
        args.data, args.cfg, args.frames, 0, os.path.join(ROOT, "build"))
    cfg = XmlConfig(cfg_path)
    *_, ack = vp_models(cfg, torch.device("cpu"))
    frames = vp_io.load(data, scale_ur=cfg.get("process.ur_scale", 1.0),
                        z_capacity=fs_vp.Z_CAPACITY,
                        n_messages=args.messages, ackerman=ack)
    # a stream with one fix (or none) loads it as a row (or nothing)
    gps = (frames.gps if frames.gps.ndim == 2
           else frames.gps.reshape(-1, 3))
    F = len(frames.t)
    chunks = _vp_common._load_out_chunks(args.ckpt_dir, F)
    outs = {k: np.concatenate([c[k] for c in chunks], axis=0)
            for k in chunks[0]}
    path = logs.ancestral_path(outs["pose"], outs["parent"],
                               outs["best"][-1])
    rec = divergence_score(frames.t, path, gps, args.from_frame)
    rec.update(stream=data, dead_reckoning_rmse_m=gps_rmse(
        frames.t, frames.dr_pose, gps))
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
