"""rfs_slam_tpu_torch core math, models, EKF correction, sim data and state
conversion against the JAX package, on the same numpy inputs."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rfs_slam_tpu.core import gaussian as jgaussian
from rfs_slam_tpu.core import planar as jplanar
from rfs_slam_tpu.io import sim2d as jsim2d
from rfs_slam_tpu.models import measurement as jmeas
from rfs_slam_tpu.models import motion as jmotion
from rfs_slam_tpu.ops import ekf as jekf
from rfs_slam_tpu_torch import convert
from rfs_slam_tpu_torch.core import gaussian, planar
from rfs_slam_tpu_torch.core.state import GMState
from rfs_slam_tpu_torch.filters.rbphd import RBPHDState
from rfs_slam_tpu_torch.io import sim2d
from rfs_slam_tpu_torch.models.measurement import RangeBearing
from rfs_slam_tpu_torch.models.motion import Odometry2D, StaticLandmark
from rfs_slam_tpu_torch.ops.ekf import InnovationGates, correct_all
from tests.torch_parity import CPU, t

R_NP = np.diag([0.0005, 0.00005]).astype(np.float32) * 10.0
RB_KW = dict(pd_const=0.99, clutter=1e-4, r_max=2.5, r_min=0.5, r_buf=0.05)


def spd_planes(rng, shape):
    A = rng.normal(size=shape + (2, 2)).astype(np.float32) * 0.3
    S = A @ np.swapaxes(A, -1, -2) + 0.05 * np.eye(2, dtype=np.float32)
    return np.stack([S[..., 0, 0], S[..., 0, 1], S[..., 1, 1]])


def scene(rng, P=5, M=12):
    """Poses, landmark planes (two slots exactly at the sensor) and
    measurements."""
    pose = np.concatenate([rng.uniform(-1, 1, (P, 2)),
                           rng.uniform(-np.pi, np.pi, (P, 1))], 1)
    pose = pose.astype(np.float32)
    pose[0] = 0.0
    mean = rng.uniform(-2.5, 2.5, (2, P, M)).astype(np.float32)
    mean[:, 0, 0] = 0.0                     # landmark at the sensor
    mean[:, 1, 1] = pose[1, :2]
    cov = spd_planes(rng, (P, M))
    z = np.stack([rng.uniform(0.3, 2.8, 9), rng.uniform(-np.pi, np.pi, 9)],
                 -1).astype(np.float32)
    return pose, mean, cov, z


@pytest.mark.parametrize("fn", ["det_sym", "inv_sym"])
def test_planar_det_inv_match_jax(rng, fn):
    s = spd_planes(rng, (4, 7))
    np.testing.assert_allclose(getattr(planar, fn)(t(s), 2).numpy(),
                               np.asarray(getattr(jplanar, fn)(s, 2)),
                               rtol=1e-6, atol=1e-7)


def test_planar_quad_sandwich_pack_match_jax(rng):
    s = spd_planes(rng, (4, 7))
    v = rng.normal(size=(2, 4, 7)).astype(np.float32)
    H = [[rng.normal(size=(4, 7)).astype(np.float32) for _ in range(2)]
         for _ in range(2)]
    np.testing.assert_allclose(planar.quad_sym(t(s), t(v), 2).numpy(),
                               np.asarray(jplanar.quad_sym(s, v, 2)),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        planar.sandwich_sym([[t(h) for h in r] for r in H], t(s), 2,
                            R=t(R_NP)).numpy(),
        np.asarray(jplanar.sandwich_sym(H, s, 2, R=jnp.asarray(R_NP))),
        rtol=1e-6, atol=1e-7)
    dense = rng.normal(size=(3, 2, 2)).astype(np.float32)
    np.testing.assert_array_equal(planar.pack_sym(t(dense)).numpy(),
                                  np.asarray(jplanar.pack_sym(dense)))
    for i, j in [(0, 0), (0, 1), (1, 0), (1, 1), (0, 2), (2, 2)]:
        assert planar.tri_index(i, j, 3) == jplanar.tri_index(i, j, 3)
    assert planar.tri_size(3) == jplanar.tri_size(3) == 6


def test_wrap_angle_rounds_half_to_even(rng):
    """jnp.round rounds half to even, so +-pi stay where they are (rounding
    half away from zero would send pi to -pi)."""
    a = np.concatenate([
        np.float32([np.pi, -np.pi, 3 * np.pi, -3 * np.pi, 5 * np.pi, 0.0]),
        rng.uniform(-20, 20, 200).astype(np.float32)])
    got = gaussian.wrap_angle(t(a)).numpy()
    np.testing.assert_allclose(got, np.asarray(jgaussian.wrap_angle(a)),
                               rtol=0, atol=2e-6)
    assert got[0] == np.float32(np.pi) and got[1] == -np.float32(np.pi)


def test_odometry_step_and_sample_match_jax(rng):
    Q = np.diag([0.002, 0.002, 0.002]) * 1.5 * 0.01
    pose = np.concatenate([rng.normal(size=(6, 2)),
                           rng.uniform(-3.1, 3.1, (6, 1))], 1).astype(
                               np.float32)
    u = np.float32([0.03, 0.01, 0.3])
    jm = jmotion.Odometry2D(Q=jnp.asarray(Q, jnp.float32))
    pm = Odometry2D(Q=t(Q, torch.float32))
    np.testing.assert_allclose(pm.step(t(pose), t(u), 0.1).numpy(),
                               np.asarray(jm.step(pose, u, 0.1)),
                               rtol=1e-6, atol=1e-6)
    keys = jax.random.split(jax.random.PRNGKey(3), 6)
    want = jax.vmap(lambda k, p: jm.sample(k, p, u, 0.1))(keys, pose)
    noise = jax.vmap(lambda k: jax.random.normal(jax.random.split(k)[1],
                                                 (3,)))(keys)
    got = pm.sample(t(pose), t(u), 0.1, noise=t(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_static_landmark_matches_jax(rng):
    Q = np.diag([0.0002, 0.0003]).astype(np.float32) * 0.01
    mean = rng.normal(size=(2, 3, 5)).astype(np.float32)
    cov = spd_planes(rng, (3, 5))
    _, want = jmotion.StaticLandmark(Q=Q).static_step_p(mean, cov, 0.1)
    _, got = StaticLandmark(Q=t(Q)).static_step_p(t(mean), t(cov), 0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7)


def test_range_bearing_matches_jax(rng):
    pose, mean, cov, z = scene(rng)
    jm = jmeas.RangeBearing(R=jnp.asarray(R_NP), **RB_KW)
    pm = RangeBearing(R=t(R_NP), **RB_KW)
    want = jm.measure_p(pose[:, None, :], mean, cov)
    got = pm.measure_p(t(pose)[:, None, :], t(mean), t(cov))
    for g, w in zip(got.z, want.z):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(got.S.numpy(), np.asarray(want.S), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert np.isfinite(got.S.numpy()).all()

    zp = [z[:, 0][None, :], z[:, 1][None, :]]
    wm, wc = jm.inverse_p(pose[:, None, :], zp)
    gm_, gc = pm.inverse_p(t(pose)[:, None, :], [t(a) for a in zp])
    np.testing.assert_allclose(gm_.numpy(), np.asarray(wm), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), rtol=1e-5,
                               atol=1e-9)

    wpd, wclose = jm.pd_p(pose[:, None, :], mean)
    gpd, gclose = pm.pd_p(t(pose)[:, None, :], t(mean))
    np.testing.assert_array_equal(gpd.numpy(), np.asarray(wpd))
    np.testing.assert_array_equal(gclose.numpy(), np.asarray(wclose))
    assert pm.clutter_intensity() == jm.clutter_intensity()
    np.testing.assert_allclose(pm.clutter_intensity_integral(),
                               float(jm.clutter_intensity_integral()),
                               rtol=1e-6)


@pytest.mark.parametrize("range_t,bearing_t", [(1.0, 0.2), (-1.0, -1.0)])
def test_correct_all_matches_jax(rng, range_t, bearing_t):
    """Every plane of the batched EKF correction, with a landmark exactly at
    the sensor (the gain's NaN scrub keeps every plane finite)."""
    pose, mean, cov, z = scene(rng)
    jm = jmeas.RangeBearing(R=jnp.asarray(R_NP), **RB_KW)
    pm = RangeBearing(R=t(R_NP), **RB_KW)
    want = jekf.correct_all(
        jm, jekf.InnovationGates.range_bearing(range_t, bearing_t), pose,
        mean, cov, z)
    got = correct_all(pm, InnovationGates.range_bearing(range_t, bearing_t),
                      t(pose), t(mean), t(cov), t(z))
    for name in ("z_exp", "S", "cov_upd", "K", "likelihood", "md2"):
        g = getattr(got, name).numpy()
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, np.asarray(getattr(want, name)),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    for name in ("valid", "measure_valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))


def test_sim2d_matches_jax_package():
    cfg = jsim2d.Sim2DConfig(timesteps=120, n_landmarks=10, n_segments=4)
    want = jsim2d.generate(cfg, traj_seed=2, noise_seed=5, z_capacity=24)
    got = sim2d.generate(sim2d.Sim2DConfig(**dataclasses.asdict(cfg)),
                         traj_seed=2, noise_seed=5, z_capacity=24)
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name),
                                      getattr(want, f.name), err_msg=f.name)


def test_convert_round_trip():
    """A JAX filter state and filter cross to the port and back unchanged."""
    from __graft_entry__ import _build, _example_inputs

    jfilt = _build(n_particles=6, map_capacity=16, z_capacity=4,
                   new_capacity=8, eval_capacity=4, z_dp_max=4)
    jstate = _example_inputs(jfilt, jax.random.PRNGKey(0))[0]
    state = convert.from_numpy(RBPHDState, jstate, CPU)
    assert isinstance(state.gm, GMState)
    back = convert.to_numpy(state)
    flat = jax.tree_util.tree_flatten_with_path(jstate)[0]
    n = 0
    for path, leaf in flat:
        keys = [p.name for p in path]
        if keys[-1] == "key":
            continue
        node = back
        for k in keys:
            node = node[k]
        np.testing.assert_array_equal(node, np.asarray(leaf),
                                      err_msg="/".join(keys))
        n += 1
    assert n == 18

    filt = convert.filter_from_numpy(jfilt, CPU)
    np.testing.assert_allclose(filt.motion.Q.numpy(),
                               np.asarray(jfilt.motion.Q))
    np.testing.assert_allclose(filt.meas.R.numpy(), np.asarray(jfilt.meas.R))
    assert filt.meas.r_max == pytest.approx(jfilt.meas.r_max)
    assert filt.gates.wrap_dims == (1,)
    assert filt.gates.thresholds == pytest.approx((1.0, 0.2))
    assert filt.cfg.map_capacity == 16
    assert filt.cfg.birth_gaussian_weight == pytest.approx(0.01)
