"""The chunked frame loop of the Victoria Park apps (port of the JAX
package's ``apps/_vp_common.py``).

A run over lidar frames is cut into fixed-size chunks.  Inside a chunk a
Python loop calls the app's per-frame step, and each frame's outputs are
written into buffers on the filter's device; nothing is read back.  At a
chunk's end the outputs reach the host once, are saved beside a snapshot of
the filter state and the generator (``utils/checkpoint.py``), and a run
that was cut resumes from the newest snapshot to the same result, bit for
bit: chunking changes no draw, since the generator's state travels in the
snapshot.  The reference has no checkpointing.
"""

from __future__ import annotations

import hashlib
import os
import time

import numpy as np
import torch

from rfs_slam_tpu_torch.utils import checkpoint
from rfs_slam_tpu_torch.utils.timing import span


def reseed_generator(gen: torch.Generator, reseed: int) -> None:
    """Reseed ``gen`` from its own state and ``reseed``: the new seed is the
    first 63 bits of SHA-256 over the generator's state bytes followed by
    ``reseed`` as 8 little-endian bytes.  Deterministic, and different for
    each ``reseed`` and each restored stream position."""
    h = hashlib.sha256(gen.get_state().numpy().tobytes()
                       + int(reseed).to_bytes(8, "little", signed=True))
    gen.manual_seed(int.from_bytes(h.digest()[:8], "little") >> 1)


def add_clutter(filt, frames, rate: float, seed: int = 0):
    """Measurements with Poisson(``rate``) artificial clutter added to each
    frame's free slots, uniform in the sensing sector
    (rbphdslam_VictoriaPark.cpp:555-580), as numpy ``(z, z_mask)``."""
    z, z_mask = frames.z.copy(), frames.z_mask.copy()
    if rate > 0:
        rng = np.random.default_rng(seed)
        m = filt.meas
        for j in range(len(z)):
            n_c = rng.poisson(rate)
            free = np.nonzero(~z_mask[j])[0]
            for i in range(min(n_c, len(free))):
                r = rng.uniform(float(m.r_min), float(m.r_max))
                b = rng.uniform(float(m.b_min), float(m.b_max))
                z[j, free[i]] = [r, b, 1.0]
                z_mask[j, free[i]] = True
    return z, z_mask


def make_frame_step(filt, step_frame, frames, gen: torch.Generator,
                    input_cov: torch.Tensor, artificial_clutter: float = 0.0,
                    clutter_seed: int = 0, mesh=None):
    """The stream's inputs (with :func:`add_clutter`) put on ``gen``'s
    device once, and ``step(state, j) -> state``: ``step_frame(filt, state,
    meas, dts, u, noise, input_cov, z, z_mask, has_z, gen)`` on frame ``j``
    with the frame's model (its scan attached when the frames carry scans).

    ``dts`` are rounded to float32 on the host, as the JAX package feeds
    them, and are 0 on the frame's padding.

    Under ``mesh`` (``parallel/mesh.py``) the state is this rank's block of
    the particle axis: each substep's input noise is drawn whole, ``[P,
    DU]``, in the unsharded run's order, and the rank keeps its block
    (``step_frame``'s ``input_noise``); ``step_frame`` gets the mesh.
    """
    dev = gen.device
    z, z_mask = add_clutter(filt, frames, artificial_clutter, clutter_seed)
    has_z = z_mask.any(axis=1)
    noise = np.asarray(frames.pred_noise)
    dts = np.where(frames.pred_valid, frames.pred_dt, 0).astype(np.float32)

    def put(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    u_d, z_d, zm_d = put(frames.pred_u), put(z), put(z_mask, torch.bool)
    scans = None if frames.scans is None else put(frames.scans)

    def step(state, j):
        meas = filt.meas if scans is None else filt.meas.with_scan(scans[j])
        sharded = {}
        if mesh is not None:
            sharded = dict(mesh=mesh, input_noise=[
                mesh.randn_block(gen, u_d.shape[-1]) if dt and nz else None
                for dt, nz in zip(dts[j], noise[j])])
        return step_frame(filt, state, meas, dts[j], u_d[j], noise[j],
                          input_cov, z_d[j], zm_d[j], bool(has_z[j]), gen,
                          **sharded)

    return step


def run_stream(filt, step_frame, state, frames, gen: torch.Generator,
               input_cov: torch.Tensor, outputs,
               artificial_clutter: float = 0.0, clutter_seed: int = 0,
               **chunking):
    """An app's run over a frame stream on ``gen``'s device:
    :func:`chunked_scan` (``chunking``: its keyword arguments) calls
    :func:`make_frame_step`'s step for each frame and ``outputs(state)``
    after it.  Returns ``(final state, outputs over the frames)``.
    """
    step = make_frame_step(filt, step_frame, frames, gen, input_cov,
                           artificial_clutter, clutter_seed)

    def frame_step(state, j):
        state = step(state, j)
        return state, outputs(state)

    state, outs, _ = chunked_scan(frame_step, state, gen, len(frames.t),
                                  **chunking)
    return state, outs


def frame_outputs(state, w: torch.Tensor, map_w=None):
    """One frame's outputs, on the device: poses [P, 3], the weights ``w``
    [P], ``best`` = argmax ``w``, and the best particle's map: xy means
    [M, 2], packed xy covariances (planes 0, 1, 3) [M, 3], weights [M]
    (``map_w`` of its row of ``gm.w`` when given), alive flags [M]; and the
    resampling parents [P]."""
    best = torch.argmax(w)
    b1 = best.view(1)
    gm = state.gm
    cov = gm.cov.index_select(1, b1)[:, 0]
    gm_w = gm.w.index_select(0, b1)[0]
    return dict(pose=state.particles.pose, w=w, best=best,
                mean=gm.mean[:2].index_select(1, b1)[:, 0].T,
                cov=torch.stack([cov[0], cov[1], cov[3]], dim=-1),
                gm_w=gm_w if map_w is None else map_w(gm_w),
                alive=gm.alive.index_select(0, b1)[0],
                parent=state.particles.parent)


def chunked_scan(frame_step, state, gen: torch.Generator, n_frames: int,
                 ckpt_dir: str | None = None, ckpt_every: int = 0,
                 resume: bool = False, progress: bool = True,
                 resume_at: int | None = None, ckpt_keep: int = 3,
                 reseed: int | None = None, check_reads: bool = False):
    """Drive ``frame_step(state, j) -> (state, outs)`` over frames
    ``0 .. n_frames - 1`` in chunks, ``outs`` a dict of device tensors of
    frame ``j``.

    Args:
      frame_step: one frame of the filter; draws from ``gen``.
      state: initial filter state (replaced by the restored one on
        resume); it also serves as the restore's template.
      gen: the run's generator; its state is saved with every snapshot
        and restored with it.
      ckpt_dir/ckpt_every/resume: snapshot controls; ``ckpt_every <= 0``
        runs one chunk.
      resume_at: resume from the snapshot at this exact frame index instead
        of the newest one.
      ckpt_keep: snapshot rotation depth (0 = keep all).
      reseed: if set, reseed the restored generator from its state and this
        value (:func:`reseed_generator`) and leave the restored filter state
        as it is: the rest of the stream under other draws from the same
        mid-run state.  JAX folds the value into its key instead; the two
        packages' streams differ in any case.
      check_reads: run each chunk's frames under torch's sync debug mode
        set to raise (on the card), so that a read from the device inside
        a chunk fails the run.

    Returns:
      (final_state, outs, wall_s) with ``outs`` a dict of numpy arrays over
      all frames (including those reloaded from before the resume).
    """
    F = n_frames
    start = 0
    if ckpt_dir is not None:
        os.makedirs(ckpt_dir, exist_ok=True)
    if (resume or resume_at is not None) and ckpt_dir is not None:
        done = (resume_at if resume_at is not None
                else checkpoint.latest_step(ckpt_dir))
        if done is not None:
            start, state = checkpoint.restore(ckpt_dir, state, step=done,
                                              gen=gen)
            print(f"resumed from frame {start} ({ckpt_dir})")
            if reseed is not None:
                reseed_generator(gen, reseed)
                print(f"reseeded the generator ({reseed})")

    C = ckpt_every if ckpt_every and ckpt_every > 0 else F
    outs_chunks = _load_out_chunks(ckpt_dir, start) if start > 0 else []
    t0 = time.time()
    f = start
    while f < F:
        c = min(C, F - f)
        bufs = None
        if check_reads:
            torch.cuda.set_sync_debug_mode("error")
        try:
            for i in range(c):
                state, outs = frame_step(state, f + i)
                if bufs is None:
                    bufs = {k: torch.empty((c,) + v.shape, dtype=v.dtype,
                                           device=v.device)
                            for k, v in outs.items()}
                for k, v in outs.items():
                    bufs[k][i] = v
        finally:
            if check_reads:
                torch.cuda.set_sync_debug_mode("default")
        with span("vp.readback"):     # the loop's one wait on the device
            outs = {k: v.cpu().numpy() for k, v in bufs.items()}
        f += c
        if ckpt_dir is not None:
            np.savez(os.path.join(ckpt_dir, f"outs_{f - c:06d}_{f:06d}.npz"),
                     **outs)
            checkpoint.save(ckpt_dir, f, state, gen=gen, keep=ckpt_keep)
        outs_chunks.append(outs)
        if progress and C < F:
            print(f"  frame {f}/{F} ({time.time() - t0:.0f}s)", flush=True)
    wall = time.time() - t0
    outs = {k: np.concatenate([o[k] for o in outs_chunks], axis=0)
            for k in outs_chunks[0]} if outs_chunks else {}
    return state, outs, wall


def _load_out_chunks(ckpt_dir: str, upto: int):
    """Reload the saved per-chunk outputs covering frames [0, upto)."""
    chunks = []
    covered = 0
    names = sorted(n for n in os.listdir(ckpt_dir)
                   if n.startswith("outs_") and n.endswith(".npz"))
    for n in names:
        f0, f1 = (int(x) for x in n[5:-4].split("_"))
        if f0 == covered and f1 <= upto:
            with np.load(os.path.join(ckpt_dir, n)) as zz:
                chunks.append({k: zz[k] for k in zz.files})
            covered = f1
    if covered != upto:
        raise FileNotFoundError(
            f"output chunks cover frames [0, {covered}), need [0, {upto}); "
            f"delete {ckpt_dir} to restart")
    return chunks


def stream_paths(data_dir: str | None, cfg_path: str | None, n_frames: int,
                 seed: int, out_dir: str) -> tuple[str, str]:
    """``(data_dir, cfg_path)`` of the stream a Victoria Park tool runs
    on: the dataset and its XML when ``data_dir`` is given (``cfg_path``
    then required), else the synthetic stream of ``io/vp_synth.py``
    (``n_frames`` frames of ``seed``, no scans) and its config, written
    under ``out_dir`` once."""
    if data_dir is not None:
        if cfg_path is None:
            raise ValueError("a dataset directory needs its XML config")
        return data_dir, cfg_path
    from rfs_slam_tpu_torch.io import vp_synth

    d = os.path.join(out_dir, f"vp_synth_seed{seed}_{n_frames}")
    if not os.path.exists(os.path.join(d, "config.xml")):
        vp_synth.write(d, seed=seed, n_frames=n_frames)
        vp_synth.write_config(os.path.join(d, "config.xml"))
    return d, os.path.join(d, "config.xml")


def add_ckpt_args(ap) -> None:
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (enables chunked snapshots)")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="snapshot every N lidar frames")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the newest snapshot in --ckpt-dir")
    ap.add_argument("--resume-at", type=int, default=None,
                    help="resume from the snapshot at this exact frame")
    ap.add_argument("--ckpt-keep", type=int, default=3,
                    help="snapshot rotation depth (0 = keep all)")
    ap.add_argument("--reseed", type=int, default=None,
                    help="reseed the restored generator with this value "
                         "(counterfactual resume probe)")
