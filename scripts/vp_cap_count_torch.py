"""How often ``murty_child_cap`` truncates on the Victoria Park MH-FastSLAM
stream of the port (the counterpart of the JAX package's
``scripts/vp_cap_count.py``).

At every kept snapshot of an MH VP run (``apps/fastslam_victoriapark.py
--ckpt-dir D --ckpt-keep 0``) it restores the state and the generator,
replays the front half of the next frame's update (the predict substeps
with the run's input-noise draws, ``_da_table``, then ``murty(...,
return_nvalid=True)`` on every live lane) and counts the in-window valid
children of each expansion wave against the cap.  Where the snapshot
directory holds no snapshots it runs the app first (``--ckpt-every``
frames apart, every snapshot kept).

The stream is the synthetic one of ``io/vp_synth.py`` (seed 0, the first
``--frames`` frames, written under ``build/``) unless ``--data DIR --cfg
XML`` name the Victoria Park log and its config, which the repository
does not hold yet.  Prints the JSON of :func:`cap_summary`.

Usage, from the repository root (on the card, or ``--device cpu``)::

    python3 scripts/vp_cap_count_torch.py [--ckpt-dir build/vp_mh_ckpt] \
        [--frames 1000] [--ckpt-every 50] [--cap 6] [--particles 200] \
        [--device cpu] [--data DIR --cfg XML]
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

from rfs_slam_tpu_torch.ops.assignment import murty  # noqa: E402

CAPS = (4, 6, 8, 12, 17)     # the JAX script's


def cap_summary(nvalid: np.ndarray, n_in_range: np.ndarray, cap: int,
                caps=CAPS) -> dict:
    """The JAX script's statistics: in-range landmarks a live lane (p50,
    p90, max), in-window valid children a wave (p50, p90, p99, max), the
    share of waves on which ``cap`` binds (more valid children than it)
    and the mean excess when it does, and the share for each of ``caps``.
    ``nvalid``: the live lanes' waves, flat; ``n_in_range``: the live
    lanes' in-range landmark counts."""
    nv, nm = np.asarray(nvalid).ravel(), np.asarray(n_in_range).ravel()
    binds = nv > cap
    return {
        "waves": int(nv.size),
        "in_range": {"p50": float(np.percentile(nm, 50)),
                     "p90": float(np.percentile(nm, 90)),
                     "max": int(nm.max())},
        "valid_children": {f"p{q}": float(np.percentile(nv, q))
                           for q in (50, 90, 99)} | {"max": int(nv.max())},
        "cap": cap, "binds_share": float(binds.mean()),
        "mean_excess_when_binding": (float((nv - cap)[binds].mean())
                                     if binds.any() else 0.0),
        "binds_share_by_cap": {str(c): float((nv > c).mean()) for c in caps}}


def count_frame(filt, state, meas, dts, u, noise, input_cov, z, z_mask,
                gen: torch.Generator, cap: int):
    """The frame's predict substeps (``fastslam_victoriapark.step_frame``'s
    loop, draws from ``gen``), its DA table and the gated expansion's
    in-window valid children: ``(nvalid [live lanes, H - 1], in-range
    landmarks [live lanes])`` as numpy."""
    for i in np.nonzero(dts)[0]:
        state = filt.predict(
            state, u[i], float(dts[i]), gen=gen, use_model_noise=False,
            use_input_noise=bool(noise[i]), input_cov=input_cov)
    table, _, row_valid, _, _ = filt._da_table(state.particles.pose,
                                               state.gm, z, z_mask, meas)
    n_m = row_valid.sum(dim=1)
    c = filt.cfg
    *_, nvalid = murty(table, c.max_hypotheses, real_rows=n_m,
                       real_cols=z_mask.sum(), child_cap=cap,
                       prune_window=c.max_da_loglik_diff, return_nvalid=True)
    live = torch.isfinite(state.particles.log_w)
    return nvalid[live].cpu().numpy(), n_m[live].cpu().numpy()


def count(ckpt_dir: str, data_dir: str, cfg_path: str, cap: int,
          particles, hypotheses: int, device: torch.device,
          messages: int = 0, seed: int = 0):
    """:func:`count_frame` at every snapshot of ``ckpt_dir`` before the
    stream's end; returns ``(snapshots counted, nvalid, in-range)``."""
    from rfs_slam_tpu_torch.apps import _vp_common
    from rfs_slam_tpu_torch.apps import fastslam_victoriapark as fs_vp
    from rfs_slam_tpu_torch.io import victoria_park as vp_io
    from rfs_slam_tpu_torch.io.xmlconfig import XmlConfig
    from rfs_slam_tpu_torch.utils import checkpoint

    cfg = XmlConfig(cfg_path)
    filt, input_cov, ack = fs_vp.build(cfg, n_particles=particles,
                                       hypotheses=hypotheses, device=device)
    frames = vp_io.load(data_dir, scale_ur=cfg.get("process.ur_scale", 1.0),
                        z_capacity=fs_vp.Z_CAPACITY, n_messages=messages,
                        ackerman=ack)
    z, z_mask = _vp_common.add_clutter(
        filt, frames, cfg.get("measurements.addedClutter", 0.0), seed)
    dts = np.where(frames.pred_valid, frames.pred_dt, 0).astype(np.float32)
    template = filt.init_state(torch.zeros(3, device=device), d=3)
    steps = sorted(int(n[5:-3]) for n in os.listdir(ckpt_dir)
                   if n.startswith("ckpt_") and n.endswith(".pt"))
    steps = [s for s in steps if s < len(frames.t)]
    gen = torch.Generator(device=device)
    nvs, nms = [], []
    for s in steps:
        _, state = checkpoint.restore(ckpt_dir, template, step=s, gen=gen)
        meas = filt.meas if frames.scans is None else filt.meas.with_scan(
            torch.as_tensor(frames.scans[s], dtype=torch.float32,
                            device=device))
        nv, nm = count_frame(
            filt, state, meas, dts[s],
            torch.as_tensor(frames.pred_u[s], dtype=torch.float32,
                            device=device),
            frames.pred_noise[s], input_cov,
            torch.as_tensor(z[s], dtype=torch.float32, device=device),
            torch.as_tensor(z_mask[s], device=device), gen, cap)
        nvs.append(nv.ravel())
        nms.append(nm)
    if not steps:
        raise FileNotFoundError(f"no snapshot before the stream's end in "
                                f"{ckpt_dir}")
    return len(steps), np.concatenate(nvs), np.concatenate(nms)


def main(argv=None):
    from rfs_slam_tpu_torch.apps import _vp_common
    from rfs_slam_tpu_torch.apps import fastslam_victoriapark as fs_vp
    from rfs_slam_tpu_torch.apps.sim2d_common import device_for

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(ROOT, "build", "vp_mh_ckpt"))
    ap.add_argument("--cap", type=int, default=6)
    ap.add_argument("--frames", type=int, default=1000,
                    help="frames of the synthetic stream")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--particles", type=int, default=None,
                    help="default: the XML's (200)")
    ap.add_argument("--hypotheses", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--data", default=None,
                    help="the Victoria Park log (default: synthetic)")
    ap.add_argument("--cfg", default=None, help="its XML config")
    ap.add_argument("--messages", type=int, default=0,
                    help="the log's first N sensor messages")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    dev = device_for(args.device)
    data, cfg = _vp_common.stream_paths(args.data, args.cfg, args.frames, 0,
                                        os.path.join(ROOT, "build"))
    t0 = time.perf_counter()
    if not (os.path.isdir(args.ckpt_dir) and any(
            n.startswith("ckpt_") for n in os.listdir(args.ckpt_dir))):
        fs_vp.main(["--cfg", cfg, "--data", data, "--device", str(dev),
                    "--hypotheses", str(args.hypotheses),
                    "--messages", str(args.messages),
                    "--ckpt-dir", args.ckpt_dir,
                    "--ckpt-every", str(args.ckpt_every), "--ckpt-keep", "0"]
                   + ([] if args.particles is None
                      else ["--particles", str(args.particles)]))
    n, nv, nm = count(args.ckpt_dir, data, cfg, args.cap, args.particles,
                      args.hypotheses, dev, args.messages)
    rec = cap_summary(nv, nm, args.cap)
    rec.update(snapshots=n, hypotheses=args.hypotheses, stream=data,
               device=str(dev), wall_s=time.perf_counter() - t0)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
