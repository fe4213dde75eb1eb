"""The RB-PHD example step at a large map capacity under a particle mesh
and particles x map meshes (the counterpart of the JAX package's
``scripts/map_shard_bench.py``).

With ``n`` ranks it runs the step of ``apps/example_step.py`` (default
M=2,048, P=8, Zc=8, 3 steps, as the JAX script) on the meshes ``(n, 1)``
(the particle mesh), ``(n/2, 2)`` and ``(n/4, 4)``, and reports for each
the collectives and bytes a rank receives a step, from the mesh's own
counts (where the JAX script counts collectives in the compiled HLO), and
ms a step: the best of three timed runs of ``--steps`` steps from the
example state, after one untimed run, the slowest rank's.

    python -m rfs_slam_tpu_torch.parallel.map_shard_bench [--ranks 8] \\
        [--map 2048] [--particles 8] [--steps 3] [--device cpu] \\
        [--backend gloo] [--out build/map_shard_results.dat]

On the card the ranks take the cards in turn; with more ranks than cards
they share them over gloo (NCCL refuses a card twice).  The results go to
``--out`` (default ``build/map_shard_results.dat`` under the repository)
in the JAX script's format, and one JSON line a mesh to the output.
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

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(ROOT, "build", "map_shard_results.dat")
Z_CAPACITY = 8
TIMED_RUNS = 3
TIMEOUT_S = 900.0


def meshes(n: int):
    """The JAX script's meshes for ``n`` ranks: (n, 1), (n/2, 2), (n/4,
    4), those that split ``n``."""
    return [(n // b, b) for b in (1, 2, 4) if n % b == 0]


def _rank(rank: int, world: int, coordinator: str, device_type: str,
          backend, particles: int, map_capacity: int, steps: int,
          out_dir: str) -> None:
    """One rank: every mesh of :func:`meshes` in turn, its record to
    ``out_dir/rank_<r>.json``."""
    import torch.distributed as dist

    from rfs_slam_tpu_torch.parallel import dryrun
    from rfs_slam_tpu_torch.parallel import mesh as mesh_lib

    device = dryrun.rank_device(rank, device_type)
    mesh_lib.init_process_group(coordinator, world, rank, device, backend)
    try:
        filt = ex.build(particles, map_capacity, Z_CAPACITY, device)
        state0, odo, z, z_mask = ex.example_inputs(filt, device)
        recs = []
        for a, b in meshes(world):
            mesh = (mesh_lib.make_mesh(particles, device) if b == 1 else
                    mesh_lib.make_mesh_2d(a, b, particles, map_capacity,
                                          device))

            def run():
                gen = torch.Generator(device=device).manual_seed(0)
                state = mesh_lib.shard_state(state0, mesh)
                for _ in range(steps):
                    state = ex.step(filt, state, odo, z, z_mask, gen, mesh)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                return state

            run()
            mesh.stats.update(collectives=0, bytes=0)
            best = float("inf")
            for _ in range(TIMED_RUNS):
                dist.barrier()
                t0 = time.perf_counter()
                state = run()
                best = min(best, time.perf_counter() - t0)
            runs = TIMED_RUNS * steps
            rec = {"p_shards": a, "m_shards": b,
                   "ms_per_step": 1e3 * best / steps,
                   "collectives_per_step": mesh.stats["collectives"] / runs,
                   "bytes_per_step": mesh.stats["bytes"] / runs,
                   "backend": dist.get_backend(mesh.group)}
            whole = mesh_lib.gather_state(state, mesh)
            rec["finite"] = bool(torch.isfinite(whole.particles.log_w).all())
            recs.append(rec)
        with open(os.path.join(out_dir, f"rank_{rank}.json"), "w") as f:
            json.dump(recs, f)
    finally:
        dist.destroy_process_group()


def bench(ranks: int, particles: int, map_capacity: int, steps: int,
          device_type: str, backend: str | None = None,
          timeout_s: float = TIMEOUT_S) -> list[dict]:
    """Every mesh of :func:`meshes` over ``ranks`` spawned ranks; one
    record a mesh: the slowest rank's ms a step, rank 0's collectives and
    bytes received a step, and whether every rank's state is finite."""
    from rfs_slam_tpu_torch.parallel import dryrun

    with tempfile.TemporaryDirectory() as d:
        dryrun.spawn_ranks(_rank, ranks, d, timeout_s, (
            device_type, backend, particles, map_capacity, steps, d))
        per_rank = []
        for r in range(ranks):
            with open(os.path.join(d, f"rank_{r}.json")) as f:
                per_rank.append(json.load(f))
    out = []
    for recs in zip(*per_rank):
        rec = dict(recs[0], ms_per_step=max(r["ms_per_step"] for r in recs),
                   finite=all(r["finite"] for r in recs), ranks=ranks,
                   particles=particles, map_capacity=map_capacity,
                   steps=steps)
        out.append(rec)
    return out


def write(path: str, recs, particles: int, map_capacity: int, steps: int,
          device: str) -> None:
    """The records in the JAX script's ``map_shard_results.dat`` format."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(f"# P={particles} M={map_capacity} steps={steps} "
                f"({device})\n# p_shards m_shards ms_per_step "
                f"collectives_per_step bytes_per_step\n")
        for r in recs:
            f.write(f"{r['p_shards']}  {r['m_shards']}  "
                    f"{r['ms_per_step']:.3f}  {r['collectives_per_step']:g}"
                    f"  {r['bytes_per_step']:.0f}\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--map", type=int, default=2048)
    ap.add_argument("--particles", type=int, default=8)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="default: the device's, gloo where ranks share a "
                         "card")
    ap.add_argument("--timeout", type=float, default=TIMEOUT_S)
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    backend = args.backend
    if args.device == "cuda":
        from rfs_slam_tpu_torch.parallel.dryrun import card_line

        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if not have:
            raise RuntimeError("no GPU found; pass --device cpu to run the "
                               "ranks on the CPU (gloo)")
        if have < args.ranks:
            backend = backend or "gloo"
        where = (f"{card_line().splitlines()[0]}; {min(have, args.ranks)} "
                 f"card(s)")
    else:
        torch.set_num_threads(1)
        where = "CPU"
    print(where, flush=True)
    recs = bench(args.ranks, args.particles, args.map, args.steps,
                 args.device, backend, args.timeout)
    for r in recs:
        print(json.dumps(r), flush=True)
    write(args.out, recs, args.particles, args.map, args.steps,
          f"{args.ranks} ranks, {recs[0]['backend']}, {where}")
    print(f"results -> {args.out}", flush=True)
    return 0 if all(r["finite"] for r in recs) else 1


if __name__ == "__main__":
    sys.exit(main())
