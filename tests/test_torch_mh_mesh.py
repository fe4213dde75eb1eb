"""MH-FastSLAM under the port's particle mesh (``filters/fastslam.py``,
``ops/assignment.py::murty_gated``) on the CPU over gloo, held to the
unsharded port and to the JAX package's MH step.

The ranks are processes of ``tests/torch_dist_worker.py`` (suite ``mh``; 2
and 4 of them, both groups at once), started before the unsharded runs of
this process so that the two overlap.  Three steps of the MH update cross
the particle blocks: the lane budget of ``murty_gated``, the grow form's
hypothesis keep and resample over the flat ``h * P_cap + p`` order, and the
fixed form's ``h * P + p`` copies.  Each takes the unsharded decisions on
gathered vectors, so ``parent``, the resampling flags, ``alive`` and the
overflow count are exact; floats hold ``dryrun.compare``'s tolerances (on
the CPU a vectorised kernel's tail can move a value by an ulp with the
block's length).
"""

import dataclasses

import numpy as np
import jax
import pytest
import torch

from rfs_slam_tpu_torch import convert
from rfs_slam_tpu_torch.apps import fastslam2dsim as fs_app
from rfs_slam_tpu_torch.apps import sim2d_common as loop
from rfs_slam_tpu_torch.filters.fastslam import FastSLAMFilter
from rfs_slam_tpu_torch.io import sim2d, sim2d_xml
from rfs_slam_tpu_torch.io.xmlconfig import XmlConfig
from rfs_slam_tpu_torch.ops.assignment import ambiguous_lanes
from rfs_slam_tpu_torch.parallel import dryrun
from tests import torch_dist_worker as worker
from tests.test_torch_fastslam import (assert_state_matches, jax_stepper,
                                       step_args, variant)
from tests.torch_parity import (CPU, fastslam_step_draws, jax_fastslam_state,
                                t)

WORLDS = (2, 4)
STEPS = 32          # each MH form's run
P = 8               # live particles (grow form: P_cap = 24)
ZC = 10
LANES, N, BUDGET = 8, 6, 3   # the lane-budget case
WARM = 12           # port steps before the one-step comparison with JAX


def mh_filters(d):
    """MH-FastSLAM of the stand-in config at P=8 live on a short, sparse
    simulation (a DA table of NMZ = Zc + 4 = 14): the grow form (H=3,
    P_cap=24, lane budget 8) with ``tests/test_fastslam.py::
    test_mh_growth_semantics``' settings (no ESS resample, every
    hypothesis kept, so the set grows until a forced resample and the
    budget binds), and the fixed form (P=8, lane budget 4)."""
    sim_cfg = sim2d.Sim2DConfig(timesteps=STEPS + 1, n_landmarks=12,
                                n_segments=2)
    cfg = XmlConfig(sim2d_xml.write_config(str(d / "mh.xml"), "mhfastslam"))
    base = fs_app.build_filter_from_xml(cfg, sim_cfg, z_capacity=ZC,
                                        n_particles=P, device=CPU)
    c = dataclasses.replace(base.cfg, nmz_capacity=ZC + 4)
    models = (base.motion, base.lmk, base.meas, base.gates)
    return sim_cfg, {
        "grow": FastSLAMFilter(*models, dataclasses.replace(
            c, min_updates_before_resample=10**6, ess_threshold=0.0,
            max_da_loglik_diff=1e6)),
        "fixed": FastSLAMFilter(*models, dataclasses.replace(
            c, mh_grow=False, murty_lane_budget=4))}


def lane_case():
    """``[8, 6, 6]`` tables, each a diagonal of its own strength over small
    noise: the gap between a lane's best and second-best assignment grows
    with the strength, so lanes 1, 3, 4, 6 and 7 are ambiguous (within the
    window of 3) and 1, 4 and 6 the most: more ambiguous lanes than the
    budget of 3, in every block of 2 and 4 ranks, the selected ones in
    three blocks."""
    strength = np.asarray([3.5, 0.3, 5.0, 2.0, 0.6, 6.0, 0.9, 2.5],
                          np.float32)
    rng = np.random.default_rng(5)
    tables = (rng.normal(0.0, 0.05, (LANES, N, N)).astype(np.float32)
              + strength[:, None, None] * np.eye(N, dtype=np.float32))
    return dict(tables=torch.from_numpy(tables),
                real_rows=torch.full((LANES,), N - 1, dtype=torch.long),
                real_cols=N - 1, k=3, child_cap=4, window=3.0,
                budget=BUDGET)


def port_warm_state(filt, data, steps):
    """The port's MH state after ``steps`` unsharded steps (generator seed
    0) of ``data``."""
    inputs = loop.sim_inputs(data, steps + 1, 24)
    return loop.steps(filt, loop.device_inputs(inputs, CPU),
                      torch.Generator().manual_seed(0), 0.1,
                      lambda k, s: None)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The sharded results of 2 and 4 ranks beside the unsharded port's
    runs and JAX's MH steps."""
    d = tmp_path_factory.mktemp("mh_mesh")
    sim_cfg, filts = mh_filters(d)
    data = sim2d.generate(sim_cfg, traj_seed=1, noise_seed=1,
                          z_capacity=ZC)
    odo, z, zm, gt, lock = loop.sim_inputs(data)
    inputs = (odo, z, zm, gt, np.zeros_like(lock))
    spec = {"runs": {name: dict(filt=f, inputs=inputs, dt=sim_cfg.dt)
                     for name, f in filts.items()},
            "lane_budget": lane_case(), "step": {}}

    # one step of tests/test_torch_fastslam.py's MH variants from a port
    # state, with JAX's draws
    jsim = sim2d.Sim2DConfig(timesteps=260, n_landmarks=20, n_segments=4)
    jdata = sim2d.generate(jsim, traj_seed=3, noise_seed=4, z_capacity=24)
    key = jax.random.PRNGKey(11)
    jax_in = {}
    for name in ("mh_grow", "mh_fixed"):
        jfilt = variant(jsim, name)
        filt = convert.filter_from_numpy(jfilt, CPU)
        state = port_warm_state(filt, jdata, WARM)
        odo_k, z_k, zm_k, gt_k, lock_k = step_args(jdata, WARM + 1)
        noise, u0 = fastslam_step_draws(key, filt.p_cap)
        spec["step"][name] = dict(filt=filt, state=state, noise=t(noise),
                                  u0=t(u0), odo=t(odo_k), z=t(z_k),
                                  z_mask=t(zm_k), gt=t(gt_k), lock=lock_k)
        jax_in[name] = (jfilt, jax_fastslam_state(convert.to_numpy(state),
                                                  key),
                        (odo_k, z_k, zm_k, gt_k, lock_k))
    torch.save(spec, d / "inputs.pt")

    procs = worker.start(d, WORLDS, "mh")
    try:
        plain = {name: worker.mh_run(run)
                 for name, run in spec["runs"].items()}
        plain["lane_budget"] = worker.lane_budget(spec["lane_budget"])
        plain["step"] = {name: worker.mh_step(s)
                         for name, s in spec["step"].items()}
        want = {name: jax_stepper(jfilt, 0.1)(jstate, *args)
                for name, (jfilt, jstate, args) in jax_in.items()}
    except BaseException:
        for _, p in procs:
            p.kill()
        raise
    return spec, worker.finish(d, procs), plain, want


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("form", ["grow", "fixed"])
def test_sharded_mh_matches_unsharded(runs, world, form):
    """32 steps of each MH form on 2 and 4 ranks against the unsharded
    port from the same generator seed: ``parent``, ``did``, every integer
    and bool field of the final state and each update's lane-budget
    overflow equal; floats within ``dryrun.compare``'s tolerances; the
    ancestors cross the ranks and the budget binds."""
    _, sharded, plain, _ = runs
    sh, pl = sharded[world][form], plain[form]
    rec = dryrun.compare(sh, pl)
    assert rec["ok"], rec
    np.testing.assert_array_equal(sh["overflow"], pl["overflow"])
    assert pl["overflow"].sum() > 0
    p_local = sh["parent"].shape[1] // world
    slots = np.arange(sh["parent"].shape[1])
    moved = (sh["parent"] // p_local) != (slots // p_local)[None, :]
    assert moved.any()
    # every update communicates: the lane keys, the weights and the rows
    assert sh["collectives"]["collectives"] >= 3 * len(pl["did"])


def test_grow_form_grows_and_collapses(runs):
    """The grow form's live set grows past the 8 live particles and is
    resampled back: the scenario reaches both sides of the keep rule."""
    live = np.isfinite(runs[2]["grow"]["log_w"]).sum(axis=1)
    assert live.max() > P and (live == P).any()


@pytest.mark.parametrize("world", WORLDS)
def test_lane_budget_takes_the_global_selection(runs, world):
    """``murty_gated`` with a budget of 3 below 8 lanes whose ambiguous
    lanes straddle the ranks: each rank expands the lanes of the global
    top 3 in its block, so every lane's hypotheses and the overflow equal
    the unsharded call's."""
    spec, sharded, plain, _ = runs
    case = spec["lane_budget"]
    amb = ambiguous_lanes(case["tables"], case["real_rows"],
                          case["real_cols"], case["window"]).numpy()
    assert amb.sum() > BUDGET
    assert all(b.any() for b in amb.reshape(world, -1))
    got, want = sharded[world]["lane_budget"], plain["lane_budget"]
    for k in ("das", "valid", "scores"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["overflow"] == want["overflow"] == amb.sum() - BUDGET
    # the expanded lanes (a second hypothesis) are in more than one block
    expanded = want["valid"][:, 1]
    assert len({int(i) // (LANES // world)
                for i in np.flatnonzero(expanded)}) > 1


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("form", ["mh_grow", "mh_fixed"])
def test_sharded_mh_step_matches_jax(runs, world, form):
    """One MH step on 2 and 4 ranks from the same state with JAX's draws
    against JAX's MH step (``tests/test_torch_fastslam.py``'s variants and
    tolerances)."""
    _, sharded, _, want = runs
    assert_state_matches(sharded[world]["step"][form], want[form])
