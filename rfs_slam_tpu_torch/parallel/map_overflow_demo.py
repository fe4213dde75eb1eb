"""The RB-PHD example step at a map capacity past the small kernels' 1,024
slots (the counterpart of the JAX package's ``scripts/map_overflow_demo.py``).

The JAX script shows that at P=64, M=8,192 its general path needs more
than a 16 GB chip (the ``[P, Zc, M]`` update cubes and the ``[P, M, M]``
merge gate) and that a particles x map mesh runs it.  The port's kernels
keep the table per CTA and the merge's mask in a workspace, so here:

* ``card``: the step on one device (P=64, M=8,192, Zc=16 by default): the
  JAX script's analytic figures, the peak device memory, ms a step, the
  kernels' forms (``launch_plan``) and launches.  On the card the steps
  run under torch's sync debug mode set to raise: nothing reads back.
* ``mesh``: the same step over an ``A x B`` particles x map mesh
  (``parallel/mesh.py``), one process a rank (NCCL ranks on the cards, one
  a card, or gloo ranks on the CPU): each rank's bytes received and ms a
  step, and the gathered state checked finite.

Usage::

    python -m rfs_slam_tpu_torch.parallel.map_overflow_demo card \\
        [--particles 64] [--map 8192] [--zc 16] [--steps 3] [--device cpu]
    python -m rfs_slam_tpu_torch.parallel.map_overflow_demo mesh \\
        [--mesh-shape 2 4] [--device cpu] [--backend gloo] [--timeout S]

Each mode prints one JSON line last.  Without ``--device cpu`` it needs
the card (``mesh``: as many cards as ranks, or ``--backend gloo``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

from rfs_slam_tpu_torch.apps import example_step as ex
from rfs_slam_tpu_torch.filters.rbphd import RBPHDConfig
from rfs_slam_tpu_torch.ops.kernels import build
from rfs_slam_tpu_torch.ops.kernels import map_update2d as mu
from rfs_slam_tpu_torch.ops.kernels import merge2d as mg

KERNELS = {"map_update2d": mu, "merge2d": mg}
TIMEOUT_S = 900.0


def analytic(p: int, m: int, zc: int) -> dict:
    """The JAX script's analytic figures (``analytic``): one ``[P, Zc,
    M]`` cube, the ``[P, M, M]`` merge gate and ~10 ``[P, M]`` planes, in
    bytes, printed as it prints them."""
    cube, gate, planes = p * zc * m * 4, p * m * m * 4, 10 * p * m * 4
    print(f"analytic per-cube [P,Zc,M] = {cube / 2**30:.2f} GiB (several "
          f"live at once); merge gate [P,M,M] = {gate / 2**30:.2f} GiB; "
          f"planes ~{planes / 2**20:.0f} MiB", flush=True)
    return {"cube_bytes": cube, "merge_gate_bytes": gate,
            "planes_bytes": planes}


def forms(p: int, m: int, zc: int, shape=(1, 1), sms: int = 0) -> dict:
    """The launch plan each kernel takes on a rank of an ``A x B`` mesh
    (``shape``) of cards with ``sms`` SMs each (0: not known): its form,
    threads, shared memory and workspace bytes.  The map update runs on
    the rank's ``M / B`` slots, the merge on the map gathered whole, each
    on ``P / A`` particles."""
    a, b = shape
    t = min(RBPHDConfig.new_per_z, m)
    return {"map_update2d": mu.launch_plan(p // a, m // b, zc, t,
                                           sms)._asdict(),
            "merge2d": mg.launch_plan(p // a, m)._asdict()}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _finite(state) -> bool:
    gm, alive = state.gm, state.gm.alive
    return bool(torch.isfinite(state.particles.log_w).all()
                and torch.isfinite(state.particles.pose).all()
                and torch.isfinite(gm.w[alive]).all()
                and torch.isfinite(gm.mean[:, alive]).all()
                and torch.isfinite(gm.cov[:, alive]).all())


def run_card(particles: int, map_capacity: int, zc: int, steps: int,
             device: torch.device) -> dict:
    """``steps`` example steps (generator seed 0) on one device.  Returns
    the kernels' launches and large-form launches in the run, ms of each
    step (CUDA events on the card, the host clock on the CPU), the peak
    device memory above what was held before (the card), the alive slots
    after the last step and whether the state is finite."""
    filt = ex.build(particles, map_capacity, zc, device)
    state, odo, z, z_mask = ex.example_inputs(filt, device)
    gen = torch.Generator(device=device).manual_seed(0)
    cuda = device.type == "cuda"
    for k in KERNELS.values():
        k.launches = k.large_launches = 0
    held = 0
    if cuda:
        _sync(device)
        torch.cuda.reset_peak_memory_stats(device)
        held = torch.cuda.memory_allocated(device)
        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(steps + 1)]
        torch.cuda.set_sync_debug_mode("error")
    stamps = [time.perf_counter()]
    try:
        if cuda:
            marks[0].record()
        for k in range(steps):
            state = ex.step(filt, state, odo, z, z_mask, gen)
            if cuda:
                marks[k + 1].record()
            else:
                stamps.append(time.perf_counter())
    finally:
        if cuda:
            torch.cuda.set_sync_debug_mode("default")
    _sync(device)
    ms = ([a.elapsed_time(b) for a, b in zip(marks, marks[1:])] if cuda
          else [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])])
    rec = {"particles": particles, "map_capacity": map_capacity, "zc": zc,
           "steps": steps, "device": str(device),
           "launches": {n: k.launches for n, k in KERNELS.items()},
           "large_launches": {n: k.large_launches
                              for n, k in KERNELS.items()},
           "ms_per_step": ms,
           "alive_after": state.gm.alive.sum(dim=1).tolist(),
           "finite": _finite(state)}
    if cuda:
        peak = torch.cuda.max_memory_allocated(device)
        rec.update(peak_bytes=peak, peak_above_held_bytes=peak - held)
    return rec


def _mesh_rank(rank: int, world: int, coordinator: str, device_type: str,
               backend, shape, particles: int, map_capacity: int, zc: int,
               steps: int, out_dir: str) -> None:
    """One rank of :func:`run_mesh`: the example state cut to the rank's
    block of the ``shape`` mesh, ``steps`` steps, each rank's bytes
    received and ms a step to ``out_dir/rank_<r>.json``, rank 0 also
    whether the gathered state is finite."""
    import torch.distributed as dist

    from rfs_slam_tpu_torch.parallel import dryrun
    from rfs_slam_tpu_torch.parallel import mesh as mesh_lib

    device = dryrun.rank_device(rank, device_type)
    mesh_lib.init_process_group(coordinator, world, rank, device, backend)
    try:
        filt = ex.build(particles, map_capacity, zc, device)
        mesh = mesh_lib.make_mesh_2d(*shape, particles, map_capacity,
                                     device)
        state, odo, z, z_mask = ex.example_inputs(filt, device)
        state = mesh_lib.shard_state(state, mesh)
        gen = torch.Generator(device=device).manual_seed(0)
        mesh.stats.update(collectives=0, bytes=0)
        ms = []
        for _ in range(steps):
            _sync(device)
            t0 = time.perf_counter()
            state = ex.step(filt, state, odo, z, z_mask, gen, mesh)
            _sync(device)
            ms.append(1e3 * (time.perf_counter() - t0))
        rec = {"rank": rank, "coords": [mesh.rank, mesh.map_rank],
               "p_local": mesh.p_local, "m_local": mesh.m_local,
               "bytes_per_step": mesh.stats["bytes"] / steps,
               "collectives_per_step": mesh.stats["collectives"] / steps,
               "ms_per_step": ms, "backend": dist.get_backend(mesh.group)}
        whole = mesh_lib.gather_state(state, mesh)
        if rank == 0:
            rec["finite"] = _finite(whole)
            rec["alive_after"] = whole.gm.alive.sum(dim=1).tolist()
        with open(os.path.join(out_dir, f"rank_{rank}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy_process_group()


def run_mesh(particles: int, map_capacity: int, zc: int, steps: int,
             shape, device_type: str, backend: str | None = None,
             timeout_s: float = TIMEOUT_S) -> dict:
    """The example step over an ``A x B`` mesh of spawned ranks
    (``dryrun.spawn_ranks``; rank ``a * B + b`` holds particle block ``a``
    and slot block ``b``).  Returns the ranks' records and the gathered
    state's check."""
    from rfs_slam_tpu_torch.parallel import dryrun

    ranks = shape[0] * shape[1]
    with tempfile.TemporaryDirectory() as d:
        dryrun.spawn_ranks(_mesh_rank, ranks, d, timeout_s, (
            device_type, backend, tuple(shape), particles, map_capacity, zc,
            steps, d))
        recs = []
        for r in range(ranks):
            with open(os.path.join(d, f"rank_{r}.json")) as f:
                recs.append(json.load(f))
    return {"particles": particles, "map_capacity": map_capacity, "zc": zc,
            "steps": steps, "mesh": list(shape), "ranks": recs,
            "finite": recs[0]["finite"],
            "alive_after": recs[0]["alive_after"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=["card", "mesh"])
    ap.add_argument("--particles", type=int, default=64)
    ap.add_argument("--map", type=int, default=8192)
    ap.add_argument("--zc", type=int, default=16)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--mesh-shape", type=int, nargs=2, default=[2, 4])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="the mesh's backend (default: the device's)")
    ap.add_argument("--timeout", type=float, default=TIMEOUT_S,
                    help="seconds before every rank is killed (mesh)")
    args = ap.parse_args(argv)
    p, m, zc = args.particles, args.map, args.zc
    ranks = args.mesh_shape[0] * args.mesh_shape[1]
    if args.device == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        need = ranks if args.mode == "mesh" and args.backend != "gloo" else 1
        if have < need:
            raise RuntimeError(f"{need} GPUs needed, {have} found; pass "
                               f"--device cpu to run on the CPU")
        from rfs_slam_tpu_torch.parallel.dryrun import card_line

        print(card_line(), flush=True)
    else:
        torch.set_num_threads(1)
    sms = build.sm_count(0) if args.device == "cuda" else 0
    rec = {"mode": args.mode, "analytic": analytic(p, m, zc),
           "forms": forms(p, m, zc, args.mesh_shape if args.mode == "mesh"
                          else (1, 1), sms)}
    if args.mode == "card":
        dev = torch.device(args.device)
        rec.update(run_card(p, m, zc, args.steps, dev))
    else:
        rec.update(run_mesh(p, m, zc, args.steps, args.mesh_shape,
                            args.device, args.backend, args.timeout))
    print(json.dumps(rec), flush=True)
    return 0 if rec["finite"] else 1


if __name__ == "__main__":
    sys.exit(main())
