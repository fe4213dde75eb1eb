"""Weak scaling of the sharded RB-PHD example step: ms a step at a fixed
number of particles a rank as the ranks grow (the counterpart of the JAX
package's ``scripts/scaling_bench.py``).

For each ``n`` of ``--ranks`` it runs the step of ``apps/example_step.py``
(``__graft_entry__._build`` / ``_example_inputs``: M=64, Zc=8,
``new_capacity`` 32, ``eval_capacity`` 8, ``z_dp_max`` 6) on the particle
mesh over ``n`` spawned ranks at P = ``--per-device`` x ``n``, then the
same total P unsharded on one rank (in this process).  Each time is the
best of three timed runs of ``--steps`` steps from the example state after
one untimed run, ``dist.barrier()`` before each, the slowest rank's.  Weak
efficiency is t(first n) / t(n), sharding overhead t(n) / t(one rank, same
total) - 1; the collectives and bytes a rank receives a step come from the
mesh's counts.

Both runs start from the same state and generator seed, so they must end
equal: ``parent`` and every map's ``alive`` bit for bit, ``log_w`` and the
poses within :data:`TOLERANCES`.  A run that fails this check makes the
command exit 1: a time from a run that computed something else is worth
nothing.  ``--perturb-rank R`` moves rank R's poses before every sharded
run, to show that the check fails.

    python -m rfs_slam_tpu_torch.parallel.scaling_bench [--ranks 1 2 4] \\
        [--per-device 32] [--map 64] [--z 8] [--steps 10] [--device cpu] \\
        [--backend gloo] [--profile] [--out build/scaling_results.dat]

On the card rank r takes card r over NCCL; where the ranks outnumber the
cards they share them over gloo (NCCL refuses a card twice).  Without a
card and without ``--device cpu`` it raises.  ``--profile`` (card only)
runs each rank once more under ``torch.profiler``: device busy ms a step,
the idle share, the NCCL kernels' ms and the launches a step.  The results
go to ``--out`` (default ``build/scaling_results.dat`` under the
repository) in the JAX script's format, and one JSON line an ``n`` to the
output.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from rfs_slam_tpu_torch.apps import example_step as ex
from rfs_slam_tpu_torch.parallel import dryrun
from rfs_slam_tpu_torch.parallel import mesh as mesh_lib

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(ROOT, "build", "scaling_results.dat")
TIMED_RUNS = 3
TIMEOUT_S = 900.0
# test_sharding.py's multistep tolerances (parallel/dryrun.py's)
TOLERANCES = {k: dryrun.TOLERANCES[k] for k in ("log_w", "pose")}
PERTURB_M = 0.05


def _final(state) -> dict:
    """The fields the equality check reads, as numpy arrays."""
    p = state.particles
    return {"parent": p.parent.cpu().numpy(), "alive": state.gm.alive.cpu()
            .numpy(), "log_w": p.log_w.cpu().numpy(),
            "pose": p.pose.cpu().numpy()}


def _covered_us(events) -> float:
    """The time the events' intervals cover, overlaps counted once (µs):
    NCCL's kernels run on a stream of their own, beside the compute."""
    total, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in events):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _profile(run, steps: int, device: torch.device) -> dict:
    """One more run under ``torch.profiler``: the device's busy ms a step
    (the time some kernel runs) and its idle share of the run's wall time,
    the time NCCL's kernels run (waiting for the other ranks included) and
    the other kernels' busy time, a step, and the launches a step."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    is_nccl = ["nccl" in e.name.lower() for e in kernels]
    busy = _covered_us(kernels) / 1e3
    return {"wall_ms_per_step": 1e3 * wall / steps,
            "device_busy_ms_per_step": busy / steps,
            "device_idle_share": 1.0 - busy / (1e3 * wall),
            "nccl_ms_per_step": _covered_us(
                [e for e, n in zip(kernels, is_nccl) if n]) / 1e3 / steps,
            "compute_ms_per_step": _covered_us(
                [e for e, n in zip(kernels, is_nccl) if not n]) / 1e3 / steps,
            "launches_per_step": len(kernels) / steps}


def time_runs(particles: int, map_capacity: int, z_capacity: int,
              steps: int, device: torch.device, mesh=None,
              perturb: bool = False, profile: bool = False):
    """The example step at ``particles`` (the mesh's block under
    ``mesh``): one untimed run, then the best of :data:`TIMED_RUNS` timed
    ones, each from the example state with generator seed 0.  Returns
    ``(record, final state)``: ms a step, the kernels' launches a step
    (their counters: on the CPU the twins run and they stay 0), and under
    ``mesh`` the collectives and bytes received a step."""
    filt = ex.build(particles, map_capacity, z_capacity, device)
    state0, odo, z, z_mask = ex.example_inputs(filt, device)
    if mesh is not None:
        state0 = mesh_lib.shard_state(state0, mesh)
    if perturb:
        state0 = dataclasses.replace(state0, particles=dataclasses.replace(
            state0.particles, pose=state0.particles.pose + PERTURB_M))

    def run():
        gen = torch.Generator(device=device).manual_seed(0)
        state = state0
        for _ in range(steps):
            state = ex.step(filt, state, odo, z, z_mask, gen, mesh)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return state

    run()
    kernels = dryrun._kernel_modules()
    for k in kernels.values():
        k.launches = 0
    if mesh is not None:
        mesh.stats.update(collectives=0, bytes=0)
    best = float("inf")
    for _ in range(TIMED_RUNS):
        if mesh is not None:
            dist.barrier()
        t0 = time.perf_counter()
        state = run()
        best = min(best, time.perf_counter() - t0)
    runs = TIMED_RUNS * steps
    rec = {"ms_per_step": 1e3 * best / steps,
           "launches_per_step": {k: m.launches / runs
                                 for k, m in kernels.items()}}
    if mesh is not None:
        rec.update(collectives_per_step=mesh.stats["collectives"] / runs,
                   bytes_per_step=mesh.stats["bytes"] / runs,
                   backend=dist.get_backend(mesh.group))
    if profile:
        if mesh is not None:
            dist.barrier()
        rec["profile"] = _profile(run, steps, device)
    return rec, state


def _rank(rank: int, world: int, coordinator: str, device_type: str,
          backend, particles: int, map_capacity: int, z_capacity: int,
          steps: int, out_dir: str, perturb_rank, profile: bool) -> None:
    """One rank of the sharded run: its record to ``out_dir/rank_<r>.json``
    and, on rank 0, the gathered final state to ``out_dir/final.npz``."""
    device = dryrun.rank_device(rank, device_type)
    mesh_lib.init_process_group(coordinator, world, rank, device, backend)
    try:
        mesh = mesh_lib.make_mesh(particles, device)
        rec, state = time_runs(particles, map_capacity, z_capacity, steps,
                               device, mesh, perturb=rank == perturb_rank,
                               profile=profile)
        whole = _final(mesh_lib.gather_state(state, mesh))
        if rank == 0:
            np.savez(os.path.join(out_dir, "final.npz"), **whole)
        with open(os.path.join(out_dir, f"rank_{rank}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy_process_group()


def sharded(ranks: int, particles: int, map_capacity: int, z_capacity: int,
            steps: int, device_type: str, backend: str | None = None,
            perturb_rank: int | None = None, profile: bool = False,
            timeout_s: float = TIMEOUT_S) -> tuple[dict, dict]:
    """The example step over ``ranks`` spawned ranks at ``particles`` in
    all.  Returns ``(record, final state)``: the slowest rank's ms a step,
    every rank's ms and kernel launches a step, rank 0's collectives and
    bytes received a step, and each rank's profile when asked; the whole
    final state from rank 0."""
    with tempfile.TemporaryDirectory() as d:
        dryrun.spawn_ranks(_rank, ranks, d, timeout_s, (
            device_type, backend, particles, map_capacity, z_capacity, steps,
            d, perturb_rank, profile))
        recs = []
        for r in range(ranks):
            with open(os.path.join(d, f"rank_{r}.json")) as f:
                recs.append(json.load(f))
        with np.load(os.path.join(d, "final.npz")) as zz:
            final = {k: zz[k] for k in zz.files}
    rec = {k: v for k, v in recs[0].items() if k != "profile"}
    rec["rank_ms_per_step"] = [r["ms_per_step"] for r in recs]
    rec["rank_launches_per_step"] = [r["launches_per_step"] for r in recs]
    rec["ms_per_step"] = max(rec["rank_ms_per_step"])
    if profile:
        rec["profile"] = [r["profile"] for r in recs]
    return rec, final


def compare(sharded_final: dict, plain_final: dict) -> dict:
    """``parent`` and ``alive`` equal, ``log_w`` and the poses within
    :data:`TOLERANCES` (infinite where the shapes differ); ``ok`` when all
    hold."""
    def max_abs(k):
        a, b = sharded_final[k], plain_final[k]
        return dryrun._max_abs(a, b) if a.shape == b.shape else float("inf")

    rec = {f"{k}_equal": bool(np.array_equal(sharded_final[k],
                                             plain_final[k]))
           for k in ("parent", "alive")}
    rec.update({f"max_abs_{k}": max_abs(k) for k in TOLERANCES})
    rec["ok"] = (rec["parent_equal"] and rec["alive_equal"]
                 and all(rec[f"max_abs_{k}"] <= t
                         for k, t in TOLERANCES.items()))
    return rec


def bench(ranks, per_device: int, map_capacity: int, z_capacity: int,
          steps: int, device_type: str, backend: str | None = None,
          perturb_rank: int | None = None, profile: bool = False,
          timeout_s: float = TIMEOUT_S) -> list[dict]:
    """One record an ``n`` of ``ranks``: the sharded run (:func:`sharded`)
    and the one-rank run at the same total P, their ms a step, weak
    efficiency against the first ``n``, sharding overhead and
    :func:`compare`'s check.  On the card ``n`` ranks take NCCL where the
    cards hold them, else gloo, unless ``backend`` is named."""
    cards = torch.cuda.device_count() if device_type == "cuda" else 0
    device = torch.device("cuda", 0) if device_type == "cuda" else \
        torch.device("cpu")
    out, t_first = [], None
    for n in ranks:
        p = per_device * n
        bk = backend or (("nccl" if n <= cards else "gloo")
                         if device_type == "cuda" else "gloo")
        rec, final = sharded(n, p, map_capacity, z_capacity, steps,
                             device_type, bk, perturb_rank, profile,
                             timeout_s)
        plain, plain_state = time_runs(p, map_capacity, z_capacity, steps,
                                       device)
        t_first = t_first or rec["ms_per_step"]
        rec.update(
            ranks=n, per_device=per_device, particles=p,
            map_capacity=map_capacity, z_capacity=z_capacity, steps=steps,
            ms_per_step_one_rank=plain["ms_per_step"],
            one_rank_launches_per_step=plain["launches_per_step"],
            weak_eff=t_first / rec["ms_per_step"],
            sharding_overhead=rec["ms_per_step"] / plain["ms_per_step"] - 1,
            equality=compare(final, _final(plain_state)))
        out.append(rec)
    return out


def write(path: str, recs, per_device: int, steps: int, platform: str
          ) -> None:
    """The records in the JAX script's ``scaling_results.dat`` format."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(f"# platform={platform} per_device_particles={per_device} "
                f"steps={steps}\n")
        f.write("# n_devices  total_particles  ms_per_step_sharded  "
                "ms_per_step_1dev_same_total  weak_eff  sharding_overhead\n")
        for r in recs:
            f.write(f"{r['ranks']}  {r['particles']}  "
                    f"{r['ms_per_step']:.3f}  "
                    f"{r['ms_per_step_one_rank']:.3f}  {r['weak_eff']:.4f}  "
                    f"{r['sharding_overhead']:.4f}\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--per-device", type=int, default=32)
    ap.add_argument("--map", type=int, default=64)
    ap.add_argument("--z", type=int, default=8)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="default: NCCL where the cards hold the ranks, "
                         "else gloo")
    ap.add_argument("--profile", action="store_true",
                    help="profile one more run on every rank (card only)")
    ap.add_argument("--perturb-rank", type=int, default=None,
                    help="move this rank's poses before each sharded run "
                         "(the equality check must then fail)")
    ap.add_argument("--timeout", type=float, default=TIMEOUT_S)
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available() or not torch.cuda.device_count():
            raise RuntimeError("no GPU found; pass --device cpu to run the "
                               "ranks on the CPU (gloo)")
        where = (f"{dryrun.card_line().splitlines()[0]}; "
                 f"{torch.cuda.device_count()} card(s)")
    else:
        if args.profile:
            raise ValueError("--profile needs the card")
        torch.set_num_threads(1)
        where = "CPU"
    print(where, flush=True)
    recs = bench(args.ranks, args.per_device, args.map, args.z, args.steps,
                 args.device, args.backend, args.perturb_rank, args.profile,
                 args.timeout)
    for r in recs:
        print(json.dumps(r), flush=True)
    write(args.out, recs, args.per_device, args.steps,
          "gpu" if args.device == "cuda" else "cpu")
    print(f"results -> {args.out}", flush=True)
    return 0 if all(r["equality"]["ok"] for r in recs) else 1


if __name__ == "__main__":
    sys.exit(main())
