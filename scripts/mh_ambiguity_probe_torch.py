"""How many MH-FastSLAM particle lanes are ambiguous, step by step, over a
2-D sim run of the port: the counts that size ``murty_lane_budget``.

``ops/assignment.py::murty_gated`` runs the full Murty expansion only on
the lanes whose root dual bound admits a second hypothesis inside
``maxDataAssocLogLikelihoodDiff`` (``ambiguous_lanes``), at most the lane
budget of them; past the budget the other ambiguous lanes keep their best
hypothesis only, so the MH result is truncated, not exact.  Before each
update that runs, this counts the ambiguous lanes of the table that
``_da_table`` gives the update (the counterpart of the JAX package's
``scripts/mh_ambiguity_probe.py``).

The run: ``sim2d.generate(traj_seed=0, noise_seed=0)``, the stand-in
``mhfastslam2dSim.xml`` of ``io/sim2d_xml.py`` wired by the port's
``fastslam2dsim.build_filter_from_xml`` (lane budget "auto" = P), the
ground-truth lock for steps <= 100, generator seed 0.  Prints the JSON of
:func:`summary`: the percentiles of the count and the share of steps on
which it exceeds each budget of the JAX script and the auto budget.

Usage, from the repository root (on the card, or ``--device cpu``)::

    python3 scripts/mh_ambiguity_probe_torch.py [--steps 400] \
        [--particles 200] [--device cpu]
"""

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rfs_slam_tpu_torch.ops.assignment import ambiguous_lanes  # noqa: E402

BUDGETS = (48, 64, 96, 128, 192)     # the JAX script's


def ambiguous_count(tables: torch.Tensor, real_rows: torch.Tensor,
                    real_cols, window: float) -> torch.Tensor:
    """The number of lanes of ``tables [P, n, n]`` that ``murty_gated``
    would expand (a 0-dim tensor on the tables' device)."""
    return ambiguous_lanes(tables, real_rows, real_cols, window).sum()


def summary(counts: np.ndarray, budget: int, budgets=BUDGETS) -> dict:
    """The JAX script's statistics of the per-step counts (mean, p50, p90,
    p99, max) and the share of steps whose count exceeds each budget, the
    filter's own ``budget`` among them."""
    counts = np.asarray(counts)
    pct = {f"p{q}": float(np.percentile(counts, q)) for q in (50, 90, 99)}
    return {"steps_counted": int(counts.size), "mean": float(counts.mean()),
            **pct, "max": int(counts.max()),
            "overflow_share": {str(b): float((counts > b).mean())
                               for b in sorted(set(budgets) | {budget})},
            "budget": budget,
            "budget_overflow_share": float((counts > budget).mean())}


def probe(filt, dinputs, gen: torch.Generator, dt: float) -> np.ndarray:
    """``apps/sim2d_common.py::steps`` with :func:`ambiguous_count` taken
    after the predict and the lock and before each update that runs (the
    steps without measurements skip the update and are not counted).
    Returns the counts of those steps; the only read is at the end."""
    odo, z, z_mask, gt, lock, has_z = dinputs
    state = filt.init_state(torch.zeros(3, device=odo.device))
    counts = torch.zeros(len(lock), dtype=torch.int64, device=odo.device)
    window = filt.cfg.max_da_loglik_diff
    for k in range(len(lock)):
        state = filt.predict(state, odo[k], dt, gen=gen)
        if lock[k]:
            pose = gt[k].expand_as(state.particles.pose).contiguous()
            state = dataclasses.replace(state, particles=dataclasses.replace(
                state.particles, pose=pose))
        if has_z[k]:
            table, _, row_valid, _, _ = filt._da_table(
                state.particles.pose, state.gm, z[k], z_mask[k], filt.meas)
            counts[k] = ambiguous_count(table, row_valid.sum(dim=1),
                                        z_mask[k].sum(dtype=torch.int32),
                                        window)
        state = filt.update(state, z[k], z_mask[k], gen=gen,
                            has_z=bool(has_z[k]))
    return counts.cpu().numpy()[np.asarray(has_z, bool)]


def main():
    from rfs_slam_tpu_torch.apps import fastslam2dsim as app
    from rfs_slam_tpu_torch.apps import sim2d_common as loop
    from rfs_slam_tpu_torch.io import sim2d, sim2d_xml
    from rfs_slam_tpu_torch.io.xmlconfig import XmlConfig, load_sim2d

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--particles", type=int, default=None,
                    help="default: the XML's (200)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    torch.set_num_threads(1)
    dev = loop.device_for(args.device)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    cfg = XmlConfig(sim2d_xml.write_config(
        os.path.join(ROOT, "build", "mhfastslam2dSim.xml"), "mhfastslam"))
    sim_cfg = load_sim2d(cfg)
    data = sim2d.generate(sim_cfg, traj_seed=0, noise_seed=0)
    zc = max(data.z.shape[1], 4)
    filt = app.build_filter_from_xml(cfg, sim_cfg, z_capacity=zc,
                                     n_particles=args.particles, device=dev)
    c = filt.cfg
    print(json.dumps({"p_cap": filt.p_cap, "hypotheses": c.max_hypotheses,
                      "nmz": c.nmz_capacity, "window": c.max_da_loglik_diff,
                      "lane_budget": c.murty_lane_budget,
                      "device": str(dev)}), flush=True)
    din = loop.device_inputs(loop.sim_inputs(data, steps=args.steps + 1,
                                             z_capacity=zc), dev)
    t0 = time.perf_counter()
    counts = probe(filt, din, torch.Generator(device=dev).manual_seed(0),
                   sim_cfg.dt)
    rec = summary(counts, c.murty_lane_budget)
    rec.update(steps=len(din[-1]), wall_s=time.perf_counter() - t0)
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
