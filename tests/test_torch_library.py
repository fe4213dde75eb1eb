"""The port's library modules against the JAX package on the same numpy
inputs: the dense Gaussian helpers, frame2d, gm.append, the dense
RangeBearing forms, XY, Range1D and Odometry1D (samplers given JAX's
draws), the map-integrity check, and the memory probes.

Tolerances: float32 results within rtol 1e-5 / atol 1e-6 (closed forms
with the JAX package's operations; only einsum and matmul sum in another
order), frame2d's 50 chained compositions within rtol 1e-4; booleans,
indices and integrity reports equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfs_slam_tpu.core import frame2d as jf
from rfs_slam_tpu.core import gaussian as jg
from rfs_slam_tpu.core.state import GMState as JGMState
from rfs_slam_tpu.models import measurement as jm
from rfs_slam_tpu.models import motion as jmo
from rfs_slam_tpu.ops import gm as jgm
from rfs_slam_tpu.utils.integrity import check_map_integrity as j_check
from rfs_slam_tpu_torch.core import frame2d as tf
from rfs_slam_tpu_torch.core import gaussian as tg
from rfs_slam_tpu_torch.core.state import GMState
from rfs_slam_tpu_torch.models import measurement as tm
from rfs_slam_tpu_torch.models import motion as tmo
from rfs_slam_tpu_torch.ops import gm as tgm
from rfs_slam_tpu_torch.utils import memprofile
from rfs_slam_tpu_torch.utils.integrity import check_map_integrity as t_check
from tests.torch_parity import assert_gm_close, jax_gm, t

RTOL, ATOL = 1e-5, 1e-6


def close(got, want, rtol=RTOL, atol=ATOL):
    if isinstance(got, (tuple, list)):
        for g, w in zip(got, want, strict=True):
            close(g, w, rtol, atol)
        return
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def spd(rng, lead, D):
    A = rng.normal(size=lead + (D, D)) * 0.5
    return (A @ np.swapaxes(A, -1, -2) + 0.3 * np.eye(D)).astype(np.float32)


@pytest.mark.parametrize("D", [1, 2, 3, 4])
def test_dense_gaussian_helpers(D):
    rng = np.random.default_rng(D)
    S = spd(rng, (6, 5), D)
    mean = rng.normal(size=(6, 5, D)).astype(np.float32)
    x = rng.normal(size=(6, 5, D)).astype(np.float32)
    for name in ("det", "inv", "chol", "symmetrize"):
        close(getattr(tg, name)(t(S)), getattr(jg, name)(jnp.asarray(S)),
              rtol=1e-4 if D == 4 else RTOL)
    close(tg.quad_form(t(S), t(x)), jg.quad_form(jnp.asarray(S),
                                                 jnp.asarray(x)))
    for name in ("mahalanobis2", "eval_likelihood", "log_likelihood"):
        close(getattr(tg, name)(t(mean), t(S), t(x)),
              getattr(jg, name)(jnp.asarray(mean), jnp.asarray(S),
                                jnp.asarray(x)),
              rtol=1e-4 if D == 4 else RTOL)
    # the sampler given JAX's draws, batched and shared covariances
    key = jax.random.PRNGKey(D)
    n = np.asarray(jax.random.normal(key, mean.shape))
    close(tg.sample(t(mean), t(S), t(n)),
          jg.sample(key, jnp.asarray(mean), jnp.asarray(S)))
    if D <= 3:
        close(tg.sample(t(mean), t(S[0, 0]), t(n)),
              jg.sample(key, jnp.asarray(mean), jnp.asarray(S[0, 0])))
    g = torch.Generator().manual_seed(0)
    assert tg.sample(t(mean), t(S), gen=g).shape == mean.shape


def test_eval_likelihood_not_finite_guard():
    S = np.zeros((2, 2, 2), np.float32)           # singular: inf / nan
    mean = np.zeros((2, 2), np.float32)
    x = np.ones((2, 2), np.float32)
    got, _ = tg.eval_likelihood(t(mean), t(S), t(x))
    want, _ = jg.eval_likelihood(jnp.asarray(mean), jnp.asarray(S),
                                 jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() == 0.0).all()


def frames(rng, lead):
    pose = rng.normal(size=lead + (3,)).astype(np.float32)
    return pose, spd(rng, lead, 3) * 0.1


def test_frame2d_matches_jax():
    rng = np.random.default_rng(3)
    pa, ca = frames(rng, (7,))
    pb, cb = frames(rng, (7,))
    close(tf.compose(t(pa), t(ca), t(pb), t(cb)),
          jf.compose(*map(jnp.asarray, (pa, ca, pb, cb))))
    close(tf.inverse(t(pa), t(ca)), jf.inverse(jnp.asarray(pa),
                                               jnp.asarray(ca)))
    pt = rng.normal(size=(7, 2)).astype(np.float32)
    close(tf.transform_point(t(pa), t(pt)),
          jf.transform_point(jnp.asarray(pa), jnp.asarray(pt)))
    # a frame composed with its inverse is the identity
    pi, _ = tf.inverse(t(pa), t(ca))
    ident, _ = tf.compose(t(pa), t(ca), pi, t(ca))
    np.testing.assert_allclose(ident.numpy(), 0.0, atol=1e-5)
    # a chain of 50 relative frames
    rel, rcov = frames(rng, (50,))
    rel[:, :2] *= 0.3
    close(tf.chain_to_base(t(rel), t(rcov)),
          jf.chain_to_base(jnp.asarray(rel), jnp.asarray(rcov)), rtol=1e-4,
          atol=1e-5)


def test_gm_append_matches_jax():
    rng = np.random.default_rng(5)
    P, M, K, D = 3, 6, 4, 2

    def planes(n):
        cov = spd(rng, (P, n), D)
        return dict(mean=rng.normal(size=(D, P, n)).astype(np.float32),
                    cov=np.stack([cov[..., 0, 0], cov[..., 0, 1],
                                  cov[..., 1, 1]]),
                    w=rng.uniform(0.1, 1.0, (P, n)).astype(np.float32),
                    alive=rng.random((P, n)) < 0.6)

    old = planes(M)
    old["w_prev"] = old["w"] * 0.5
    old["w"][0, :3] = 0.5                          # ties across the union
    new = planes(K)
    new["w"][0, :2] = 0.5
    new["alive"][0, :2] = True
    for cap in (None, 5, M + K):
        want = jgm.append(jax_gm(old), *(jnp.asarray(new[k]) for k in
                                         ("mean", "cov", "w", "alive")),
                          capacity=cap)
        got = tgm.append(GMState(**{k: t(v) for k, v in old.items()}),
                         *(t(new[k]) for k in ("mean", "cov", "w", "alive")),
                         capacity=cap)
        assert got.capacity == want.capacity
        assert_gm_close(got, want, rtol=0, atol=0)


def models(kind, R):
    kw = dict(pd_const=0.9, clutter=0.2, r_max=4.0, r_min=0.5, r_buf=0.3)
    return (getattr(jm, kind)(R=jnp.asarray(R), **kw),
            getattr(tm, kind)(R=t(R), **kw))


def dense_inputs(rng, D, lead=(4, 9)):
    pose = np.zeros(lead + (3,), np.float32)
    pose[...] = rng.normal(size=lead[:1] + (1, 3)) * [1.0, 1.0, 2.0]
    lm = (pose[..., :D] + rng.uniform(-5.0, 5.0, lead + (D,))).astype(
        np.float32)
    lm[0, 0, :D] = pose[0, 0, :D]                 # a landmark at the sensor
    return pose, lm, spd(rng, lead, D) * 0.2


@pytest.mark.parametrize("kind", ["RangeBearing", "XY"])
def test_planar_2d_models_match_jax(kind):
    rng = np.random.default_rng(11)
    R = np.array([[0.04, 0.005], [0.005, 0.02]], np.float32)
    jmod, tmod = models(kind, R)
    pose, lm, cov = dense_inputs(rng, 2)
    J = lambda a: jnp.asarray(a)
    close(tmod.measure(t(pose), t(lm), t(cov)),
          jmod.measure(J(pose), J(lm), J(cov)))
    close(tmod.measure(t(pose), t(lm)), jmod.measure(J(pose), J(lm)))
    close(tmod.pd(t(pose), t(lm)), jmod.pd(J(pose), J(lm)))
    z = np.asarray(jmod.measure(J(pose), J(lm)).z)
    close(tmod.inverse(t(pose), t(z)), jmod.inverse(J(pose), J(z)))

    # the plane layout: landmarks [D, P, M], packed covariances
    mean_p = np.moveaxis(lm, -1, 0)
    cov_p = np.stack([cov[..., 0, 0], cov[..., 0, 1], cov[..., 1, 1]])
    pose_p = pose
    for c in (cov_p, None):
        got = tmod.measure_p(t(pose_p), t(mean_p),
                             None if c is None else t(c))
        want = jmod.measure_p(J(pose_p), J(mean_p),
                              None if c is None else J(c))
        close(got.z, want.z)
        close(got.S, want.S)
        close([h for row in got.H for h in row],
              [jnp.broadcast_to(h, got.valid.shape)
               for row in want.H for h in row])
        close(got.valid, want.valid)
    z_p = tuple(np.moveaxis(z, -1, 0))
    close(tmod.inverse_p(t(pose_p), tuple(map(t, z_p))),
          jmod.inverse_p(J(pose_p), tuple(map(J, z_p))))
    close(tmod.pd_p(t(pose_p), t(mean_p)), jmod.pd_p(J(pose_p), J(mean_p)))
    assert tmod.clutter_intensity() == float(jmod.clutter_intensity())
    np.testing.assert_allclose(tmod.clutter_intensity_integral(),
                               float(jmod.clutter_intensity_integral()),
                               rtol=1e-6)


def test_range_bearing_sample_given_jax_draws():
    rng = np.random.default_rng(12)
    R = np.array([[0.04, 0.0], [0.0, 0.02]], np.float32)
    jmod, tmod = models("RangeBearing", R)
    pose, lm, _ = dense_inputs(rng, 2)
    key = jax.random.PRNGKey(3)
    want = jmod.sample(key, jnp.asarray(pose), jnp.asarray(lm))
    n = np.asarray(jax.random.normal(key, lm.shape))
    close(tmod.sample(t(pose), t(lm), t(n)), want)
    z, valid = tmod.sample(t(pose), t(lm), gen=torch.Generator())
    assert z.shape == lm.shape and valid.shape == lm.shape[:-1]


def test_range1d_matches_jax():
    rng = np.random.default_rng(13)
    R = np.array([[0.05]], np.float32)
    jmod, tmod = models("Range1D", R)
    pose = rng.normal(size=(4, 9, 1)).astype(np.float32)
    lm = (pose + rng.uniform(-5.0, 5.0, (4, 9, 1))).astype(np.float32)
    cov = (rng.uniform(0.1, 0.5, (4, 9, 1, 1))).astype(np.float32)
    J = lambda a: jnp.asarray(a)
    for c in (cov, None):
        close(tmod.measure(t(pose), t(lm), None if c is None else t(c)),
              jmod.measure(J(pose), J(lm), None if c is None else J(c)))
    close(tmod.pd(t(pose), t(lm)), jmod.pd(J(pose), J(lm)))
    z = lm - pose
    close(tmod.inverse(t(pose), t(z)), jmod.inverse(J(pose), J(z)))
    mean_p, cov_p = np.moveaxis(lm, -1, 0), cov[..., 0, 0][None]
    for c in (cov_p, None):
        got = tmod.measure_p(t(pose), t(mean_p), None if c is None else t(c))
        want = jmod.measure_p(J(pose), J(mean_p), None if c is None else J(c))
        close(got.z, want.z)
        close(got.S, want.S)
        close(got.H[0][0], want.H[0][0])
        close(got.valid, want.valid)
    z_p = (t(z[..., 0]),)
    close(tmod.inverse_p(t(pose), z_p), jmod.inverse_p(J(pose),
                                                       (J(z[..., 0]),)))
    close(tmod.pd_p(t(pose), t(mean_p)), jmod.pd_p(J(pose), J(mean_p)))
    assert tmod.clutter_intensity() == float(jmod.clutter_intensity())
    np.testing.assert_allclose(tmod.clutter_intensity_integral(),
                               float(jmod.clutter_intensity_integral()),
                               rtol=1e-6)


@pytest.mark.parametrize("input_noise", [False, True])
def test_odometry1d_matches_jax(input_noise):
    rng = np.random.default_rng(14)
    Q = np.array([[0.03]], np.float32)
    U = np.array([[0.2]], np.float32)
    jmod, tmod = jmo.Odometry1D(Q=jnp.asarray(Q)), tmo.Odometry1D(Q=t(Q))
    pose = rng.normal(size=(16, 1)).astype(np.float32)
    u = np.array([0.7], np.float32)
    close(tmod.step(t(pose), t(u), 0.1), jmod.step(jnp.asarray(pose),
                                                   jnp.asarray(u), 0.1))
    key = jax.random.PRNGKey(9)
    want = jmod.sample(key, jnp.asarray(pose), jnp.asarray(u), 0.1,
                       use_input_noise=input_noise, input_cov=jnp.asarray(U))
    k_in, k_add = jax.random.split(key)
    n_in = np.asarray(jax.random.normal(k_in, pose.shape))
    n = np.asarray(jax.random.normal(k_add, pose.shape))
    got = tmod.sample(t(pose), t(u), 0.1, noise=t(n),
                      use_input_noise=input_noise, input_cov=t(U),
                      input_noise=t(n_in))
    close(got, want)
    g = torch.Generator().manual_seed(0)
    assert tmod.sample(t(pose), t(u), 0.1, gen=g).shape == pose.shape


def integrity_cases():
    """The four maps of tests/test_aux.py::test_check_map_integrity, plus a
    NaN weight and a negative weight."""
    P, M, D = 2, 4, 2
    base = dict(mean=np.zeros((D, P, M), np.float32),
                cov=np.stack([np.ones((P, M)), np.zeros((P, M)),
                              np.ones((P, M))]).astype(np.float32),
                w=np.zeros((P, M), np.float32),
                w_prev=np.zeros((P, M), np.float32),
                alive=np.zeros((P, M), bool))
    base["mean"][:, 0, 0] = 1.0
    base["cov"][:, 0, 0] = [0.1, 0.0, 0.1]
    base["w"][0, 0] = 0.5
    base["alive"][0, 0] = True

    def edit(key, index, value):
        d = {k: v.copy() for k, v in base.items()}
        d[key][index] = value
        return d

    return [base,
            edit("mean", (0, 0, 0), np.nan),
            edit("mean", (0, 0, 3), np.nan),      # a dead slot: ignored
            edit("cov", (slice(None), 0, 0), [0.1, -0.2, 0.1]),
            edit("w", (0, 0), np.nan),
            edit("w", (0, 0), -0.5)]


@pytest.mark.parametrize("case", range(6))
@pytest.mark.parametrize("log_odds", [False, True])
def test_check_map_integrity_matches_jax(case, log_odds):
    d = integrity_cases()[case]
    want = j_check(JGMState(**{k: jnp.asarray(v) for k, v in d.items()}),
                   weights_are_log_odds=log_odds)
    got = t_check(GMState(**{k: t(v) for k, v in d.items()}),
                  weights_are_log_odds=log_odds)
    assert got == want
    assert got[0] == (case in (0, 2) or (case == 5 and log_odds))


def test_memprofile_probes():
    rss, peak = memprofile.current_rss(), memprofile.peak_rss()
    assert 0 < rss <= peak
    assert memprofile.device_memory("cpu") == {}
    assert memprofile.device_memory(torch.device("cpu")) == {}
    text = memprofile.report()
    assert text.startswith("host RSS: ")
    assert len(text.splitlines()) == 1 + torch.cuda.device_count()
