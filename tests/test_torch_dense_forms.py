"""The dense boundary forms of the port against the JAX package on the same
numpy inputs: ``GMState.from_dense`` / ``mean_dense`` / ``cov_dense`` /
``n_particles``, ``ParticleState.n_particles``, ``InnovationGates.none`` /
``innovation``, ``StaticLandmark.static_step``, and the Victoria Park
model's ``measure`` / ``inverse`` / ``pd`` / ``_pd_single`` with the
measure/inverse round trip of ``tests/test_victoria_park.py``.

Tolerances: float32 results within rtol 1e-5 / atol 1e-6 (the dense forms
go through the plane forms, whose sums run in another order than JAX's
matmuls); shapes, booleans and Pd table values equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfs_slam_tpu.core.state import GMState as JGMState
from rfs_slam_tpu.core.state import ParticleState as JParticleState
from rfs_slam_tpu.models.motion import StaticLandmark as JStaticLandmark
from rfs_slam_tpu.models.victoria_park import VictoriaPark as JVictoriaPark
from rfs_slam_tpu.models.victoria_park import fov_area_clutter
from rfs_slam_tpu.ops.ekf import InnovationGates as JGates
from rfs_slam_tpu_torch import convert
from rfs_slam_tpu_torch.core.state import GMState, ParticleState
from rfs_slam_tpu_torch.models.motion import StaticLandmark
from rfs_slam_tpu_torch.models.victoria_park import VictoriaPark
from rfs_slam_tpu_torch.ops.ekf import InnovationGates
from tests.torch_parity import CPU, t

RTOL, ATOL = 1e-5, 1e-6


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


def spd(rng, shape, d):
    a = rng.normal(size=shape + (d, d)).astype(np.float32)
    return (a @ np.swapaxes(a, -1, -2) * 0.1
            + np.eye(d, dtype=np.float32)).astype(np.float32)


@pytest.mark.parametrize("d", [2, 3])
def test_gm_from_dense_round_trip(rng, d):
    """``from_dense`` packs like JAX's (``w_prev`` zeros, every slot alive
    by default), and ``mean_dense`` / ``cov_dense`` give the dense arrays
    back; ``n_particles`` of both containers."""
    P, M = 3, 5
    mean = rng.normal(size=(P, M, d)).astype(np.float32)
    cov = spd(rng, (P, M), d)
    w = rng.uniform(size=(P, M)).astype(np.float32)
    want = JGMState.from_dense(jnp.asarray(mean), jnp.asarray(cov),
                               jnp.asarray(w))
    got = GMState.from_dense(t(mean), t(cov), t(w))
    for name in ("mean", "cov", "w", "w_prev", "alive"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    np.testing.assert_array_equal(got.mean_dense.numpy(),
                                  np.asarray(want.mean_dense))
    np.testing.assert_array_equal(got.cov_dense.numpy(),
                                  np.asarray(want.cov_dense))
    np.testing.assert_array_equal(got.cov_dense.numpy(), cov)
    alive = rng.uniform(size=(P, M)) < 0.5
    part = GMState.from_dense(t(mean), t(cov), t(w), t(w) * 0.5, t(alive))
    np.testing.assert_array_equal(part.alive.numpy(), alive)
    np.testing.assert_array_equal(part.w_prev.numpy(), w * 0.5)
    assert got.n_particles == want.n_particles == P
    ps = ParticleState.init(P + 1, torch.zeros(3))
    jps = JParticleState.init(jax.random.PRNGKey(0), P + 1, jnp.zeros(3))
    assert ps.n_particles == jps.n_particles == P + 1


@pytest.mark.parametrize("gates", ["range_bearing", "none", "victoria_park"])
def test_innovation_stacked(rng, gates):
    """``innovation`` on stacked ``[..., DZ]``: the angle wrapped, the
    gate mask; ``none`` wraps and gates nothing."""
    if gates == "range_bearing":
        jg, g = (JGates.range_bearing(0.5, 0.2),
                 InnovationGates.range_bearing(0.5, 0.2))
    elif gates == "victoria_park":
        jg, g = (JGates.victoria_park(1.0, 0.3, 0.1),
                 InnovationGates.victoria_park(1.0, 0.3, 0.1))
    else:
        jg, g = JGates.none(3), InnovationGates.none(3)
    dz = len(g.thresholds)
    # bearings anywhere, half the measurements a turn away: the wrap
    z_exp = rng.uniform(-3.1, 3.1, (4, 6, dz))
    z_act = z_exp + 0.4 * rng.normal(size=(4, 6, dz))
    z_act[..., 1] += 2 * np.pi * (rng.uniform(size=(4, 6)) < 0.5)
    z_exp, z_act = z_exp.astype(np.float32), z_act.astype(np.float32)
    want, want_ok = jg.innovation(jnp.asarray(z_exp), jnp.asarray(z_act))
    got, ok = g.innovation(t(z_exp), t(z_act))
    close(got, want)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
    assert 0 < int(ok.sum()) < ok.numel() or gates == "none"


@pytest.mark.parametrize("per_dt2", [False, True])
def test_static_step_dense(rng, per_dt2):
    Q = np.diag([0.02, 0.03, 0.01]).astype(np.float32)
    mean = rng.normal(size=(2, 5, 3)).astype(np.float32)
    cov = spd(rng, (2, 5), 3)
    jm, jc = JStaticLandmark(Q=jnp.asarray(Q), per_dt2=per_dt2).static_step(
        jnp.asarray(mean), jnp.asarray(cov), 0.025)
    m, c = StaticLandmark(Q=t(Q), per_dt2=per_dt2).static_step(
        t(mean), t(cov), 0.025)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    close(c, jc)


def vp_models():
    """test_victoria_park.py's model, in JAX and in the port."""
    jmod = JVictoriaPark(
        R=jnp.diag(jnp.asarray([0.025, 2.5e-5, 2e-3])),
        slb=jnp.asarray(1e-5),
        pd_table=jnp.asarray([0.0, 0.2, 0.4, 0.6, 0.8, 0.9]),
        r_max=70.0, r_min=1.0, b_max=3.09, b_min=-3.09,
        clutter_value=fov_area_clutter(3.0, 1.0, 70.0, -3.09, 3.09))
    return jmod, convert.from_numpy(VictoriaPark, jmod, CPU)


def vp_inputs(rng, n=64):
    """Poses [n, 3], trees [n, 3] (x, y, diameter) around them, their
    covariances [n, 3, 3]."""
    pose = np.concatenate([rng.uniform(-20, 20, (n, 2)),
                           rng.uniform(-np.pi, np.pi, (n, 1))], 1)
    r = rng.uniform(0.5, 80.0, n)
    b = rng.uniform(-np.pi, np.pi, n)
    lm = np.stack([pose[:, 0] + r * np.cos(b), pose[:, 1] + r * np.sin(b),
                   rng.uniform(0.1, 1.0, n)], 1)
    return (pose.astype(np.float32), lm.astype(np.float32),
            spd(rng, (n,), 3) * 0.5)


@pytest.mark.parametrize("with_cov", [False, True])
def test_vp_measure_dense(rng, with_cov):
    jmod, mod = vp_models()
    pose, lm, cov = vp_inputs(rng)
    want = jmod.measure(jnp.asarray(pose), jnp.asarray(lm),
                        jnp.asarray(cov) if with_cov else None)
    got = mod.measure(t(pose), t(lm), t(cov) if with_cov else None)
    for name in ("z", "S", "H_lmk", "H_pose"):
        close(getattr(got, name), getattr(want, name))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.S.shape == (len(pose), 3, 3)


def test_vp_inverse_dense(rng):
    jmod, mod = vp_models()
    pose, lm, _ = vp_inputs(rng)
    z = np.asarray(jmod.measure(jnp.asarray(pose), jnp.asarray(lm)).z)
    want_m, want_c = jmod.inverse(jnp.asarray(pose), jnp.asarray(z))
    got_m, got_c = mod.inverse(t(pose), t(z))
    close(got_m, want_m, atol=1e-4)
    close(got_c, want_c)


def test_vp_measure_inverse_roundtrip():
    """test_victoria_park.py's round trip on the port: the inverse of the
    prediction is the landmark, S is symmetric positive definite, and the
    diameter's variance grows with range."""
    _, m = vp_models()
    pose = torch.tensor([1.0, 2.0, 0.3])
    lm = torch.tensor([6.0, 8.0, 0.5])
    pred = m.measure(pose, lm)
    mean, _ = m.inverse(pose, pred.z)
    np.testing.assert_allclose(mean.numpy(), lm.numpy(), atol=1e-5)
    S = pred.S.numpy()
    np.testing.assert_allclose(S, S.T, atol=1e-7)
    assert np.all(np.linalg.eigvalsh(S) > 0)
    S_far = m.measure(pose, torch.tensor([40.0, 40.0, 0.5])).S.numpy()
    assert S_far[2, 2] > S[2, 2]


@pytest.mark.parametrize("with_cov", [False, True])
def test_vp_pd_dense(rng, with_cov):
    """Multi-probe Pd and the close-to-limit flag; one disc's Pd."""
    jmod, mod = vp_models()
    pose, lm, cov = vp_inputs(rng, 256)
    want_pd, want_close = jmod.pd(jnp.asarray(pose), jnp.asarray(lm),
                                  jnp.asarray(cov) if with_cov else None)
    got_pd, got_close = mod.pd(t(pose), t(lm), t(cov) if with_cov else None)
    np.testing.assert_array_equal(got_pd.numpy(), np.asarray(want_pd))
    np.testing.assert_array_equal(got_close.numpy(), np.asarray(want_close))
    assert 0 < int((got_pd > 0).sum()) < len(pose)
    want1 = jmod._pd_single(jnp.asarray(pose), jnp.asarray(lm[:, :2]),
                            jnp.asarray(lm[:, 2]))
    got1 = mod._pd_single(t(pose), t(lm[:, :2]), t(lm[:, 2]))
    for g, w in zip(got1, want1, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
