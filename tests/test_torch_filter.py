"""The port's RB-PHD filter against the JAX package: one full predict +
update step with JAX's own random draws injected, the RFS likelihood, the
resampling ops, and a short port-only run held to the JAX test's bands."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from __graft_entry__ import _build, _example_inputs
from rfs_slam_tpu.filters.rbphd import RBPHDFilter as JRBPHDFilter
from rfs_slam_tpu.ops import resample as jresample
from rfs_slam_tpu.ops.rfs_likelihood import rfs_log_likelihood as jrfs
from rfs_slam_tpu_torch import convert
from rfs_slam_tpu_torch.apps import sim2d_common as loop
from rfs_slam_tpu_torch.filters.rbphd import LOG_TINY, RBPHDFilter, RBPHDState
from rfs_slam_tpu_torch.io import sim2d
from rfs_slam_tpu_torch.ops import resample
from rfs_slam_tpu_torch.ops.rfs_likelihood import rfs_log_likelihood
from tests.test_rbphd_filter import build_filter
from tests.torch_parity import (CPU, assert_gm_close, jax_state, step_draws,
                                t)

DT = 0.1


@pytest.fixture(scope="module")
def step_pair():
    """The JAX filter of __graft_entry__._build at small sizes, its port,
    and one jitted JAX predict + update step."""
    jfilt = _build(n_particles=16, map_capacity=128, z_capacity=24,
                   new_capacity=32, eval_capacity=8, z_dp_max=6)
    filt = convert.filter_from_numpy(jfilt, CPU)

    @jax.jit
    def jstep(state, odo, z, z_mask):
        state = jfilt.predict(state, odo, DT)
        return jfilt.update(state, z, z_mask)

    return jfilt, filt, jstep


def assert_step_matches(filt, jstep, jstate, odo, z, z_mask):
    noise, u0 = step_draws(jstate.particles.key, filt.cfg.n_particles)
    want = jstep(jstate, odo, z, z_mask)
    state = convert.from_numpy(RBPHDState, jstate, CPU)
    state = filt.predict(state, t(odo, torch.float32), DT, noise=t(noise))
    got = filt.update(state, t(z, torch.float32), t(z_mask), u0=t(u0))

    np.testing.assert_array_equal(got.particles.parent.numpy(),
                                  np.asarray(want.particles.parent))
    np.testing.assert_allclose(got.particles.pose.numpy(),
                               np.asarray(want.particles.pose), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got.particles.log_w.numpy(),
                               np.asarray(want.particles.log_w), rtol=1e-4,
                               atol=1e-4)
    assert_gm_close(got.gm, want.gm)
    for name in ("last_unused", "n_in_fov", "n_updates", "n_meas", "last_z"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    return got


def test_one_step_matches_jax_on_example_inputs(step_pair):
    jfilt, filt, jstep = step_pair
    jstate, odo, z, z_mask = _example_inputs(jfilt, jax.random.PRNGKey(0))
    got = assert_step_matches(filt, jstep, jstate, np.asarray(odo),
                              np.asarray(z), np.asarray(z_mask))
    assert int(got.gm.alive.sum()) > 0


def test_one_step_matches_jax_mid_run(step_pair):
    """A mid-run state: the port after 119 steps of a short simulation
    (past the ground-truth lock, maps populated, births pending), converted
    to JAX, one step on both."""
    jfilt, filt, jstep = step_pair
    sim_cfg = sim2d.Sim2DConfig(timesteps=200, n_landmarks=20, n_segments=4)
    data = sim2d.generate(sim_cfg, traj_seed=3, noise_seed=4, z_capacity=24)
    k = 120
    state, _ = loop.run(filt, loop.sim_inputs(data, steps=k),
                        torch.Generator().manual_seed(2), DT)
    assert bool(state.last_unused.any()) and int(state.gm.alive.sum()) > 50
    jstate = jax_state(convert.to_numpy(state), jax.random.PRNGKey(7))
    got = assert_step_matches(filt, jstep, jstate, data.odometry[k],
                              data.z[k], data.z_mask[k])
    assert int(got.gm.alive.sum()) > 50


def test_consecutive_steps_match_jax_from_jax_states(step_pair, short_sim):
    """Teacher-forced: JAX runs 40 steps of a short simulation; at every
    step the port starts from JAX's state with JAX's draws and must land on
    JAX's next state (births, first merges and resamples included)."""
    jfilt, filt, jstep = step_pair
    _, data = short_sim
    jstate = jfilt.init_state(jax.random.PRNGKey(3), jnp.zeros(3))
    identity = np.arange(filt.cfg.n_particles)
    resamples = 0
    for k in range(1, 41):
        args = (np.asarray(data.odometry[k], np.float32), data.z[k],
                data.z_mask[k])
        assert_step_matches(filt, jstep, jstate, *args)
        jstate = jstep(jstate, *args)
        resamples += int((np.asarray(jstate.particles.parent)
                          != identity).any())
    assert int(jstate.gm.alive.sum()) > 50
    assert resamples > 0


def test_rfs_log_likelihood_matches_jax(rng):
    """Random gated tables with support-less rows (the zero-partition Pd
    quirk), inactive rows and columns, and more supported columns than the
    DP keeps."""
    P, E, Z = 5, 6, 11
    L = rng.uniform(0, 2, (P, E, Z)).astype(np.float32)
    L *= rng.uniform(size=(P, E, Z)) < 0.4
    L[:, 0, :] = 0.0
    pd = rng.uniform(0.5, 0.99, (P, E)).astype(np.float32)
    row_active = rng.uniform(size=(P, E)) < 0.85
    clutter = np.full((1, Z), 0.05, np.float32)
    z_active = np.arange(Z) < 10
    want = jrfs(jnp.asarray(L), jnp.asarray(pd), jnp.asarray(row_active),
                jnp.asarray(clutter), jnp.asarray(z_active), 0.3, z_dp_max=6)
    got = rfs_log_likelihood(t(L), t(pd), t(row_active), t(clutter),
                             t(z_active), 0.3, z_dp_max=6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


def test_resample_ops_match_jax(rng):
    log_w = (rng.normal(size=40) * 2).astype(np.float32)
    np.testing.assert_allclose(
        resample.normalize_log_weights(t(log_w)).numpy(),
        np.asarray(jresample.normalize_log_weights(log_w)), atol=1e-5)
    np.testing.assert_allclose(resample.effective_count(t(log_w)).item(),
                               float(jresample.effective_count(log_w)),
                               rtol=1e-4)
    key = jax.random.PRNGKey(5)
    u0 = np.asarray(jax.random.uniform(key, (), jnp.float32))
    np.testing.assert_array_equal(
        resample.systematic_ancestors(t(u0), t(log_w), 40).numpy(),
        np.asarray(jresample.systematic_ancestors(key, jnp.asarray(log_w),
                                                  40)))
    for thr, allow in ((1.0, True), (40.0, True), (40.0, False)):
        want = jresample.maybe_resample(key, jnp.asarray(log_w), thr,
                                        allow=allow)
        got = resample.maybe_resample(t(u0), t(log_w), thr, t(allow))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   atol=1e-5)
        assert bool(got[2]) == bool(want[2])


def test_importance_weights_without_eval_points_match_jax(step_pair):
    """eval_capacity 0 (the reference's empty strategy): every particle
    gets denorm_min, as in the JAX package."""
    jfilt, filt, _ = step_pair
    jf = JRBPHDFilter(jfilt.motion, jfilt.lmk, jfilt.meas, jfilt.gates,
                      dataclasses.replace(jfilt.cfg, eval_capacity=0))
    pf = RBPHDFilter(filt.motion, filt.lmk, filt.meas, filt.gates,
                     dataclasses.replace(filt.cfg, eval_capacity=0))
    jstate, _, z, z_mask = _example_inputs(jfilt, jax.random.PRNGKey(0))
    want = jf._importance_weights(jstate.particles.log_w,
                                  jstate.particles.pose, jstate.gm, z,
                                  z_mask, None, None)
    state = convert.from_numpy(RBPHDState, jstate, CPU)
    got = pf._importance_weights(state.particles.log_w, state.particles.pose,
                                 state.gm, t(z), t(z_mask), None, None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() == LOG_TINY).all()


@pytest.fixture(scope="module")
def short_sim():
    cfg = sim2d.Sim2DConfig(timesteps=260, n_landmarks=20, n_segments=4)
    return cfg, sim2d.generate(cfg, traj_seed=3, noise_seed=4, z_capacity=24)


def test_port_short_run_within_jax_bands(short_sim):
    """tests/test_rbphd_filter.py::test_rbphd_short_run's bands, on the
    port alone: whole runs agree with the JAX package only in
    distribution."""
    sim_cfg, data = short_sim
    filt = convert.filter_from_numpy(build_filter(sim_cfg), CPU)
    state, best = loop.run(filt, loop.sim_inputs(data),
                           torch.Generator().manual_seed(0), sim_cfg.dt)
    assert np.isfinite(best).all()
    err = np.linalg.norm(best[:, :2] - data.gt_pose[1:, :2], axis=1)
    assert err[99] < 1e-4            # still locked at k=100
    assert np.median(err[150:]) < 0.6, np.median(err[150:])
    best_i = int(torch.argmax(state.particles.log_w))
    assert int(state.gm.alive[best_i].sum()) > 3
    assert torch.isfinite(state.gm.w[state.gm.alive]).all()


def test_port_birth_from_unused_and_empty_update(short_sim):
    sim_cfg, data = short_sim
    filt = convert.filter_from_numpy(build_filter(sim_cfg, n_particles=4),
                                     CPU)
    state = filt.init_state(torch.zeros(3))
    empty = filt.update(state, torch.zeros(24, 2),
                        torch.zeros(24, dtype=torch.bool))
    assert int(empty.n_updates) == 1 and int(empty.n_meas) == 0
    assert empty.particles is state.particles

    k = int(np.argmax(data.z_count > 1))
    zm = t(data.z_mask[k])
    state = filt.update(state, t(data.z[k], torch.float32), zm,
                        u0=torch.tensor(0.5))
    assert int(state.gm.count()[0]) == 0
    np.testing.assert_array_equal(state.last_unused[0].numpy(), zm.numpy())
    state = filt.predict(state, torch.zeros(3), sim_cfg.dt,
                         noise=torch.zeros(4, 3))
    assert int(state.gm.count()[0]) == int(data.z_count[k])
    w = state.gm.w[0][state.gm.alive[0]].numpy()
    np.testing.assert_allclose(w, 0.01, rtol=1e-5)
