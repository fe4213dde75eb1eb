"""The port's FastSLAM 1.0 / MH-FastSLAM against the JAX package: steps from
the same state with JAX's own draws injected (FastSLAM 1.0, MH grow mode,
the fixed-shape MH branch, the candidate pipeline, a map smaller than the
DA table), teacher-forced over consecutive steps.

Discrete outputs (ancestors, alive masks, candidate slots, counters) are
equal; floats use ``assert_gm_close``'s tolerances (rtol 1e-4, atol 1e-5;
weights atol 1e-6), poses rtol 1e-5 / atol 1e-6 and log-weights rtol 1e-4
/ atol 1e-4."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rfs_slam_tpu.filters import fastslam as jfs
from rfs_slam_tpu_torch import convert
from rfs_slam_tpu_torch.filters import fastslam as pfs
from rfs_slam_tpu_torch.io import sim2d
from tests.test_fastslam import build_filter
from tests.torch_parity import (CPU, assert_gm_close, fastslam_step_draws,
                                t)

# steps JAX runs alone before the comparison: past the ground-truth lock
# for FastSLAM 1.0, fewer (inside it) for the slower MH variants
WARM_STEPS = {"h1": 110, "candidates": 110, "small_map": 110, "mh_grow": 20,
              "mh_fixed": 20}


@pytest.fixture(scope="module")
def short_sim():
    cfg = sim2d.Sim2DConfig(timesteps=260, n_landmarks=20, n_segments=4)
    return cfg, sim2d.generate(cfg, traj_seed=3, noise_seed=4, z_capacity=24)


def variant(sim_cfg, name):
    """tests/test_fastslam.py's filter at P <= 8 (MH: 4 live of 12) in the
    configurations the update branches on."""
    if name == "h1":
        return build_filter(sim_cfg, n_particles=8)
    if name in ("candidates", "small_map"):
        f = build_filter(sim_cfg, n_particles=8)
        # threshold 2: the candidate state machine; a map of 16 slots under
        # a 28-row DA table: padding rows (index M) that the scatter drops
        change = ({"cand_count_threshold": 2} if name == "candidates"
                  else {"map_capacity": 16})
        return jfs.FastSLAMFilter(f.motion, f.lmk, f.meas, f.gates,
                                  dataclasses.replace(f.cfg, **change))
    f = build_filter(sim_cfg, n_particles=4, max_hypotheses=3)
    cfg = dataclasses.replace(f.cfg, murty_lane_budget=4,
                              mh_grow=name == "mh_grow")
    if name == "mh_grow":
        # tests/test_fastslam.py::test_mh_growth_semantics's settings: no
        # ESS resample, every hypothesis kept, so the set grows until a
        # forced resample (and every lane is ambiguous: the budget binds)
        cfg = dataclasses.replace(cfg, min_updates_before_resample=10**6,
                                  ess_threshold=0.0, max_da_loglik_diff=1e6)
    return jfs.FastSLAMFilter(f.motion, f.lmk, f.meas, f.gates, cfg)


def jax_stepper(jfilt, dt):
    @jax.jit
    def step(state, odo, z, z_mask, gt, lock):
        state = jfilt.predict(state, odo, dt)
        pose = jnp.where(lock, jnp.broadcast_to(gt, state.particles.pose.shape),
                         state.particles.pose)
        state = state.replace(particles=state.particles.replace(pose=pose))
        return jfilt.update(state, z, z_mask)
    return step


def step_args(data, k):
    return (np.asarray(data.odometry[k], np.float32),
            np.asarray(data.z[k], np.float32), data.z_mask[k],
            np.asarray(data.gt_pose[k], np.float32), k <= 100)


def port_step(filt, jstate, odo, z, z_mask, gt, lock):
    """The port's step from JAX's state with JAX's draws."""
    noise, u0 = fastslam_step_draws(jstate.particles.key, filt.p_cap)
    state = convert.from_numpy(pfs.FastSLAMState, jstate, CPU)
    state = filt.predict(state, t(odo), 0.1, noise=t(noise))
    if lock:
        state = dataclasses.replace(state, particles=dataclasses.replace(
            state.particles, pose=t(gt).expand(filt.p_cap, 3).contiguous()))
    return filt.update(state, t(z), t(z_mask), u0=t(u0))


def assert_state_matches(got, want):
    np.testing.assert_array_equal(got.particles.parent.numpy(),
                                  np.asarray(want.particles.parent))
    np.testing.assert_allclose(got.particles.pose.numpy(),
                               np.asarray(want.particles.pose), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got.particles.log_w.numpy(),
                               np.asarray(want.particles.log_w), rtol=1e-4,
                               atol=1e-4)
    assert_gm_close(got.gm, want.gm)
    a = np.asarray(want.cand.alive)
    np.testing.assert_array_equal(got.cand.alive.numpy(), a)
    for name in ("n_support", "n_checks"):
        np.testing.assert_array_equal(getattr(got.cand, name).numpy()[a],
                                      np.asarray(getattr(want.cand, name))[a])
    np.testing.assert_allclose(got.cand.mean.numpy()[:, a],
                               np.asarray(want.cand.mean)[:, a], rtol=1e-4,
                               atol=1e-5)
    for name in ("n_in_fov", "n_updates", "n_meas"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


@pytest.fixture(scope="module", params=["h1", "mh_grow", "mh_fixed",
                                        "candidates", "small_map"])
def midrun(request, short_sim):
    """(name, JAX filter, its port, JAX step, JAX state after WARM_STEPS)."""
    sim_cfg, data = short_sim
    jfilt = variant(sim_cfg, request.param)
    jstep = jax_stepper(jfilt, sim_cfg.dt)
    jstate = jfilt.init_state(jax.random.PRNGKey(1), jnp.zeros(3))
    for k in range(1, WARM_STEPS[request.param] + 1):
        jstate = jstep(jstate, *step_args(data, k))
    return (request.param, jfilt, convert.filter_from_numpy(jfilt, CPU),
            jstep, jstate)


def test_steps_match_jax_from_jax_states(midrun, short_sim):
    """Teacher-forced: from JAX's mid-run state, at each step the port
    starts from JAX's state with JAX's draws and must land on JAX's next
    state.  FastSLAM 1.0 runs 20 steps, the MH variants 6, the candidate
    pipeline and the small map 4; in grow mode the live set must grow and collapse
    back to n_particles on a forced resample."""
    name, _, filt, jstep, jstate = midrun
    _, data = short_sim
    assert int(np.asarray(jstate.gm.alive).sum()) > 10
    n_steps = {"h1": 20, "candidates": 4, "small_map": 4}.get(name, 6)
    live = [int(np.isfinite(np.asarray(jstate.particles.log_w)).sum())]
    k0 = WARM_STEPS[name] + 1
    for k in range(k0, k0 + n_steps):
        args = step_args(data, k)
        got = port_step(filt, jstate, *args)
        jstate = jstep(jstate, *args)
        assert_state_matches(got, jstate)
        live.append(int(np.isfinite(np.asarray(jstate.particles.log_w)).sum()))
    if name == "mh_grow":
        assert max(live) > 4 and any(
            b == 4 and a > 4 for a, b in zip(live, live[1:])), live


def test_filter_config_converts(midrun):
    name, jfilt, filt, _, _ = midrun
    assert filt.cfg == pfs.FastSLAMConfig(**{
        f.name: getattr(jfilt.cfg, f.name)
        for f in dataclasses.fields(pfs.FastSLAMConfig)})
    assert filt.p_cap == jfilt.p_cap


def test_init_and_empty_update(short_sim):
    sim_cfg, _ = short_sim
    filt = convert.filter_from_numpy(variant(sim_cfg, "mh_grow"), CPU)
    state = filt.init_state(torch.zeros(3))
    lw = state.particles.log_w.numpy()
    assert lw.shape == (12,) and np.isinf(lw[4:]).all()
    np.testing.assert_allclose(np.exp(lw[:4]), 0.25, rtol=1e-6)
    empty = filt.update(state, torch.zeros(24, 2),
                        torch.zeros(24, dtype=torch.bool))
    assert int(empty.n_updates) == 1 and empty.particles is state.particles


def test_existence_log_odds_delta_matches_jax(rng):
    pd = rng.uniform(0, 1, 50).astype(np.float32)
    updated = rng.random(50) < 0.5
    locked = rng.random(50) < 0.3
    for p_fa in (0.05, 0.5):
        want = jfs.existence_log_odds_delta(
            jnp.asarray(pd), jnp.float32(p_fa), 0.5, jnp.asarray(updated),
            jnp.asarray(locked))
        got = pfs.existence_log_odds_delta(t(pd), torch.tensor(p_fa), 0.5,
                                           t(updated), t(locked))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
