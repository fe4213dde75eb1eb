"""The port's Victoria Park path against the JAX package, on the same numpy
inputs: D=3 planar algebra, Ackerman motion with input noise, the
VictoriaPark model (with and without covariance and scan), correct_single,
the io copies, the birth-candidate state machine, the general map update,
and the whole slice teacher-forced over consecutive synthetic frames."""

import dataclasses
import filecmp

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rfs_slam_tpu.apps import rbphdslam_victoriapark as japp
from rfs_slam_tpu.core import planar as jplanar
from rfs_slam_tpu.io import logs as jlogs
from rfs_slam_tpu.io import victoria_park as jvp_io
from rfs_slam_tpu.io.xmlconfig import XmlConfig as JXmlConfig
from rfs_slam_tpu.models import motion as jmotion
from rfs_slam_tpu.ops import ekf as jekf
from rfs_slam_tpu_torch import convert
from rfs_slam_tpu_torch.apps import rbphdslam_victoriapark as app
from rfs_slam_tpu_torch.core import planar
from rfs_slam_tpu_torch.filters.rbphd import RBPHDState
from rfs_slam_tpu_torch.io import logs, vp_synth
from rfs_slam_tpu_torch.io import victoria_park as vp_io
from rfs_slam_tpu_torch.io.xmlconfig import XmlConfig
from rfs_slam_tpu_torch.models.motion import (Ackerman2D, Odometry2D,
                                              StaticLandmark)
from rfs_slam_tpu_torch.ops.ekf import InnovationGates, correct_single
from rfs_slam_tpu_torch.ops.kernels import merge3d as merge3d_mod
from tests.torch_parity import (CPU, assert_gm_close, jax_state,
                                predict_input_draws, resample_offset, t)

P, M = 8, 64
N_FRAMES = 14


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    """A 14-frame synthetic stream with scans, its config, and the JAX
    and port filters built from it (P=8, M=64)."""
    d = tmp_path_factory.mktemp("vp")
    assert vp_synth.write(str(d), seed=0, n_frames=N_FRAMES, scans=True) == 0
    cfg_path = vp_synth.write_config(str(d / "config.xml"))
    jfilt, jicov, ack = japp.build(JXmlConfig(cfg_path), z_capacity=24,
                                   map_capacity=M, n_particles=P)
    filt, icov, _ = app.build(XmlConfig(cfg_path), map_capacity=M,
                              n_particles=P, device=torch.device("cpu"))
    return dict(dir=d, cfg=cfg_path, jfilt=jfilt, jicov=jicov, filt=filt,
                icov=icov, ack=ack,
                frames=vp_io.load(str(d), z_capacity=24, ackerman=ack))


def spd3_planes(rng, shape, scale=0.3):
    A = rng.normal(size=shape + (3, 3)).astype(np.float32) * scale
    S = A @ np.swapaxes(A, -1, -2) + 0.05 * np.eye(3, dtype=np.float32)
    return np.stack([S[..., i, j] for i in range(3) for j in range(i, 3)])


def scene(rng, n_p=6, m=40):
    """Poses (particle 0 at the exact origin), landmark planes in and
    around the lidar's sector (slot 0 of particle 0 at the sensor) with
    covariances, and measurements."""
    pose = np.concatenate([rng.uniform(-2, 2, (n_p, 2)),
                           rng.uniform(-np.pi, np.pi, (n_p, 1))], 1)
    pose = pose.astype(np.float32)
    pose[0] = 0.0
    r = rng.uniform(3.0, 75.0, (n_p, m))
    b = rng.uniform(-0.2, 3.3, (n_p, m))
    a = pose[:, 2:] - np.pi / 2 + b
    mean = np.stack([pose[:, :1] + r * np.cos(a), pose[:, 1:2] + r * np.sin(a),
                     rng.uniform(0.1, 1.0, (n_p, m))]).astype(np.float32)
    mean[:, 0, 0] = [0.0, 0.0, 0.3]
    cov = spd3_planes(rng, (n_p, m), scale=0.2)
    z = np.stack([rng.uniform(5, 70, 24), rng.uniform(0.1, 3.1, 24),
                  rng.uniform(0.15, 0.8, 24)], -1).astype(np.float32)
    return pose, mean, cov, z


def rows(x):
    return np.stack([np.stack([np.asarray(v) for v in r]) for r in x])


@pytest.mark.parametrize("fn", ["det_sym", "inv_sym", "chol_sym"])
def test_planar_d3_matches_jax(rng, fn):
    """rtol 1e-5: the same formulas in the same order; XLA may contract a
    product into a sum where torch rounds both."""
    s = spd3_planes(rng, (4, 7))
    got = getattr(planar, fn)(t(s), 3)
    want = getattr(jplanar, fn)(jnp.asarray(s), 3)
    if fn == "chol_sym":
        got, want = rows(got), rows(want)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_motion_models_with_input_noise_match_jax(rng):
    """Ackerman2D and Odometry2D step and sample with JAX's own input and
    model draws injected (poses near +-pi exercise the single-branch wrap);
    StaticLandmark's per-dt^2 growth.  rtol 1e-5 / atol 1e-5 m."""
    n = 16
    pose = np.concatenate([rng.uniform(-20, 20, (n, 2)),
                           rng.uniform(-np.pi, np.pi, (n, 1))], 1)
    pose[:4, 2] = [np.pi - 1e-3, -np.pi + 1e-3, 3.1, -3.1]
    pose = pose.astype(np.float32)
    dt = np.float32(0.025)
    keys = jax.random.split(jax.random.PRNGKey(3), n)
    k_in = jax.vmap(lambda k: jax.random.split(k)[0])(keys)
    k_add = jax.vmap(lambda k: jax.random.split(k)[1])(keys)

    jack = jmotion.Ackerman2D(Q=np.zeros((3, 3), np.float32), h=0.76,
                              l=2.83, dx=3.78, dy=0.5)
    ack = convert.from_numpy(Ackerman2D, jack, CPU)
    u = np.float32([3.0, 0.3])
    icov = np.diag([0.2, 0.025]).astype(np.float32)
    draws = np.asarray(jax.vmap(lambda k: jax.random.normal(
        k, (2,), jnp.float32))(k_in))
    np.testing.assert_allclose(
        ack.step(t(pose), t(u), float(dt)).numpy(),
        np.asarray(jack.step(jnp.asarray(pose), u, dt)), rtol=1e-5,
        atol=1e-5)
    for noisy in (True, False):
        want = jax.vmap(lambda k, p: jack.sample(
            k, p, u, dt, use_model_noise=False, use_input_noise=noisy,
            input_cov=icov))(keys, jnp.asarray(pose))
        got = ack.sample(t(pose), t(u), float(dt), use_model_noise=False,
                         use_input_noise=noisy, input_cov=t(icov),
                         input_noise=t(draws))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)

    jodo = jmotion.Odometry2D(Q=np.diag([1e-3, 2e-3, 1e-3]).astype(
        np.float32))
    odo = convert.from_numpy(Odometry2D, jodo, CPU)
    u3 = np.float32([0.1, 0.02, 0.05])
    icov3 = np.diag([1e-3, 1e-3, 5e-4]).astype(np.float32)
    want = jax.vmap(lambda k, p: jodo.sample(
        k, p, u3, 0.1, use_model_noise=True, use_input_noise=True,
        input_cov=icov3))(keys, jnp.asarray(pose))
    draws3 = np.asarray(jax.vmap(lambda k: jax.random.normal(
        k, (3,), jnp.float32))(k_in))
    noise3 = np.asarray(jax.vmap(lambda k: jax.random.normal(
        k, (3,), jnp.float32))(k_add))
    got = odo.sample(t(pose), t(u3), 0.1, noise=t(noise3),
                     use_input_noise=True, input_cov=t(icov3),
                     input_noise=t(draws3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)

    jlm = jmotion.StaticLandmark(Q=np.diag([5e-4, 5e-4, 1e-4]), per_dt2=True)
    lm = convert.from_numpy(StaticLandmark, jlm, CPU)
    cov = spd3_planes(rng, (3, 5))
    np.testing.assert_array_equal(
        lm.static_step_p(None, t(cov), np.float32(0.0375))[1].numpy(),
        np.asarray(jlm.static_step_p(None, jnp.asarray(cov),
                                     jnp.float32(0.0375))[1]))


@pytest.mark.parametrize("scan", [False, True])
def test_victoria_park_model_matches_jax(rng, stream, scan):
    """measure_p and inverse_p (rtol 1e-5 / atol 1e-5), pd_p with and
    without covariance (Pd exact, close-to-limit exact), on a scan or
    without one."""
    jm, m = stream["jfilt"].meas, stream["filt"].meas
    pose, mean, cov, z = scene(rng)
    if scan:
        forest = vp_synth.trees(np.random.default_rng(0))
        s = vp_synth.laser_scan(np.zeros(3), forest).astype(np.float32)
        jm, m = jm.with_scan(jnp.asarray(s)), m.with_scan(t(s))
        np.testing.assert_allclose(float(m.clutter_value),
                                   float(jm.clutter_value), rtol=1e-5)
        np.testing.assert_array_equal(m.scan720.numpy(),
                                      np.asarray(jm.scan720))
    jp = jnp.asarray(pose)[:, None, :]
    tp = t(pose)[:, None, :]
    for c in (None, cov):
        want = jm.measure_p(jp, jnp.asarray(mean),
                            None if c is None else jnp.asarray(c))
        got = m.measure_p(tp, t(mean), None if c is None else t(c))
        for g, w in ((torch.stack(list(got.z)), jnp.stack(want.z)),
                     (got.S, want.S)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-5)
        w_pd, w_close = jm.pd_p(jp, jnp.asarray(mean),
                                None if c is None else jnp.asarray(c))
        g_pd, g_close = m.pd_p(tp, t(mean), None if c is None else t(c))
        np.testing.assert_array_equal(g_pd.numpy(), np.asarray(w_pd))
        np.testing.assert_array_equal(g_close.numpy(), np.asarray(w_close))
        assert (g_pd.numpy() > 0).sum() > 10
    zp = [z[:, d][None, :] for d in range(3)]
    w_mean, w_cov = jm.inverse_p(jp, [jnp.asarray(a) for a in zp])
    g_mean, g_cov = m.inverse_p(tp, [t(a) for a in zp])
    np.testing.assert_allclose(g_mean.numpy(), np.asarray(w_mean), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(g_cov.numpy(), np.asarray(w_cov), rtol=1e-5,
                               atol=1e-8)


def test_correct_single_matches_jax(rng, stream):
    """Including a landmark at the sensor of a particle at the origin (the
    clamped Jacobian keeps it finite) and a non-finite measurement (the
    NaN guard keeps the landmark unchanged and invalid).  rtol 1e-4 /
    atol 1e-5."""
    jm, m = stream["jfilt"].meas, stream["filt"].meas
    gates = InnovationGates.victoria_park()
    jgates = jekf.InnovationGates.victoria_park()
    pose, mean, cov, z = scene(rng, n_p=5, m=24)
    zp = np.stack([z[:, d][None, :].repeat(5, 0) for d in range(3)])
    zp[0, 1, 3] = np.inf
    want = jekf.correct_single(jm, jgates, jnp.asarray(pose)[:, None, :],
                               jnp.asarray(mean), jnp.asarray(cov),
                               jnp.asarray(zp))
    got = correct_single(m, gates, t(pose)[:, None, :], t(mean), t(cov),
                         t(zp))
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)
    assert not bool(got[4][1, 3]) and bool(got[4][0, 0])
    np.testing.assert_array_equal(got[0][:, 1, 3].numpy(), mean[:, 1, 3])
    assert np.isfinite(got[0].numpy()).all() and np.isfinite(
        got[1].numpy()).all()


def test_io_copies_match_jax(stream, tmp_path):
    """xmlconfig, victoria_park.load (with and without a message limit)
    and the log writers give the JAX modules' results on the same files."""
    cfg, jcfg = XmlConfig(stream["cfg"]), JXmlConfig(stream["cfg"])
    assert cfg.get_list("measurements.Pd", "value") == list(vp_synth.PD_TABLE)
    assert cfg.get_list("measurements.Pd", "value") == jcfg.get_list(
        "measurements.Pd", "value")
    for key, default in (("process.varuv", 0.2), ("filter.nParticles", 100),
                         ("filter.weighting.useClusterProcess", False)):
        assert cfg.get(key, default) == jcfg.get(key, default)
    with pytest.raises(KeyError):
        cfg.get("measurements.nothing")

    for n_msgs in (0, 60):
        got = vp_io.load(str(stream["dir"]), scale_ur=1.5, z_capacity=24,
                         n_messages=n_msgs, ackerman=stream["ack"])
        want = jvp_io.load(str(stream["dir"]), scale_ur=1.5, z_capacity=24,
                           n_messages=n_msgs, ackerman=stream["ack"])
        for f in dataclasses.fields(want):
            np.testing.assert_array_equal(getattr(got, f.name),
                                          getattr(want, f.name),
                                          err_msg=f.name)

    rng = np.random.default_rng(2)
    T, n = 5, 4
    times = np.arange(T) * 0.3
    poses, w = rng.normal(size=(T, n, 3)), rng.uniform(size=(T, n))
    means, covs = rng.normal(size=(T, 6, 2)), rng.uniform(size=(T, 6, 3))
    gw, alive = rng.uniform(size=(T, 6)), rng.uniform(size=(T, 6)) < 0.6
    best = rng.integers(0, n, T)
    parents = rng.integers(0, n, (T, n))
    for mod, d in ((logs, tmp_path / "port"), (jlogs, tmp_path / "jax")):
        mod.write_particle_poses(str(d), times, poses, w)
        mod.write_landmark_estimates(str(d), times, best, means, covs, gw,
                                     alive)
        mod.write_trajectory(str(d), times, poses[:, 0])
    for name in ("particlePose.dat", "landmarkEst.dat", "trajectory.dat"):
        assert filecmp.cmp(tmp_path / "port" / name, tmp_path / "jax" / name,
                           shallow=False), name
    np.testing.assert_array_equal(logs.ancestral_path(poses, parents, 1),
                                  jlogs.ancestral_path(poses, parents, 1))


def test_port_build_matches_converted_jax_build(stream):
    """The port's build reads the same keys and defaults as the JAX app:
    its filter equals the JAX filter carried across by convert.py."""
    filt = stream["filt"]
    conv = convert.filter_from_numpy(stream["jfilt"], CPU)
    assert filt.cfg == conv.cfg
    assert filt.gates == conv.gates
    for a, b in ((filt.motion, conv.motion), (filt.lmk, conv.lmk),
                 (filt.meas, conv.meas)):
        assert type(a) is type(b)
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, torch.Tensor):
                np.testing.assert_array_equal(x.numpy(), y.numpy(),
                                              err_msg=f.name)
            else:
                assert x == y, f.name
    np.testing.assert_array_equal(stream["icov"].numpy(),
                                  np.asarray(stream["jicov"], np.float32))


def birth_state(rng, jfilt):
    """A JAX state with birth candidates in every condition: matched by one
    or two unused measurements (duplicate candidates and duplicate
    measurements make ties), unmatched, at the support and check
    thresholds; particles with few and many landmarks in the FOV."""
    cfg = jfilt.cfg
    C, Zc = cfg.birth_capacity, cfg.z_capacity
    state = jfilt.init_state(jax.random.PRNGKey(0), jnp.zeros(3), dz=3, d=3)
    pose = np.concatenate([rng.uniform(-1, 1, (P, 2)),
                           rng.uniform(-0.3, 0.3, (P, 1))], 1)
    pose = pose.astype(np.float32)
    n_z = 14
    z = np.zeros((Zc, 3), np.float32)
    z[:n_z] = np.stack([rng.uniform(6, 40, n_z), rng.uniform(0.2, 2.9, n_z),
                        rng.uniform(0.2, 0.8, n_z)], -1)
    z[5] = z[4]                                  # duplicate measurement
    unused = np.zeros((P, Zc), bool)
    unused[:, :n_z] = rng.uniform(size=(P, n_z)) < 0.7
    unused[:, 4:6] = True
    zp = [jnp.asarray(z[:, d])[None, :] for d in range(3)]
    inv_mean, inv_cov = (np.asarray(a) for a in jfilt.meas.inverse_p(
        jnp.asarray(pose)[:, None, :], zp))
    mean = np.zeros((3, P, C), np.float32)
    cov = np.asarray(state.birth.cov).copy()
    alive = rng.uniform(size=(P, C)) < 0.6
    src = rng.integers(0, n_z, (P, C))
    src[:, 1] = src[:, 0]                        # duplicate candidates
    src[:, 2] = 4
    for p in range(P):
        mean[:, p] = inv_mean[:, p, src[p]]
        cov[:, p] = inv_cov[:, p, src[p]]
    mean[:2] += rng.normal(size=(2, P, C)).astype(np.float32) * 0.2
    mean[:2, :, 1] = mean[:2, :, 0]
    alive[:, :3] = True
    alive[:, -4:] = False
    n_support = rng.integers(0, 5, (P, C)).astype(np.int32)
    n_support[:, 0] = 4                          # one support from promotion
    n_checks = rng.integers(0, 11, (P, C)).astype(np.int32)
    birth = state.birth.replace(mean=jnp.asarray(mean), cov=jnp.asarray(cov),
                                n_support=jnp.asarray(n_support),
                                n_checks=jnp.asarray(n_checks),
                                alive=jnp.asarray(alive))
    n_in_fov = np.where(np.arange(P) % 3 == 0, 1, 5).astype(np.int32)
    return state.replace(
        particles=state.particles.replace(pose=jnp.asarray(pose)),
        birth=birth, last_z=jnp.asarray(z),
        last_unused=jnp.asarray(unused), n_in_fov=jnp.asarray(n_in_fov))


def test_add_birth_gaussians_state_machine_matches_jax(rng, stream):
    """birth_count_threshold 5: candidates alive, n_support, n_checks and
    the promoted and immediately born map slots exact; means and
    covariances rtol 1e-4 / atol 1e-5."""
    jfilt, filt = stream["jfilt"], stream["filt"]
    assert filt.cfg.birth_count_threshold == 5
    jst = birth_state(rng, jfilt)
    jgm, jbirth = jfilt._add_birth_gaussians(jst, jst.particles.key)
    st = convert.from_numpy(RBPHDState, jst, CPU)
    gm, birth = filt._add_birth_gaussians(st)
    assert_gm_close(gm, jgm)
    for f in ("alive", "n_support", "n_checks"):
        np.testing.assert_array_equal(getattr(birth, f).numpy(),
                                      np.asarray(getattr(jbirth, f)),
                                      err_msg=f)
    a = np.asarray(jbirth.alive)
    for f in ("mean", "cov"):
        np.testing.assert_allclose(getattr(birth, f).numpy()[:, a],
                                   np.asarray(getattr(jbirth, f))[:, a],
                                   rtol=1e-4, atol=1e-5, err_msg=f)
    # every branch ran: supports, new candidates, promotions, immediates
    assert (birth.n_support.numpy() > st.birth.n_support.numpy())[
        st.birth.alive.numpy()].any()
    assert (birth.alive.numpy() & ~st.birth.alive.numpy()).any()
    assert int(gm.alive.sum()) > 0 and (~birth.alive.numpy()
                                        & st.birth.alive.numpy()).any()


def test_tie_order_of_sorts_and_arg_reductions_matches_jax():
    """The state machine's stable argsort of bool masks and first-index
    argmin / argmax agree with jnp's on tie-heavy rows."""
    rng = np.random.default_rng(4)
    mask = rng.uniform(size=(6, 24)) < 0.5
    np.testing.assert_array_equal(
        torch.argsort(t(mask).int(), dim=1, stable=True).numpy(),
        np.asarray(jnp.argsort(jnp.asarray(mask), axis=1)))
    v = rng.integers(0, 3, (6, 24, 10)).astype(np.float32)
    v[0] = np.inf
    for fn in ("argmin", "argmax"):
        np.testing.assert_array_equal(getattr(t(v), fn)(dim=2).numpy(),
                                      np.asarray(getattr(jnp, fn)(v, axis=2)))


def mid_state(stream, k):
    """The port's state after ``k`` frames of the stream (seed 1)."""
    filt, fr = stream["filt"], stream["frames"]
    fr = app.head(fr, k)
    fr.scans = None
    state, _ = app.run(filt, stream["icov"], fr, torch.Generator()
                       .manual_seed(1))
    return state


@pytest.mark.parametrize("scan", [False, True])
def test_general_map_update_matches_jax(stream, scan):
    """The non-fused map update on a mid-run state (10 frames in): the
    updated map (alive exact), log-weights, unused flags, FOV counts and
    clutter intensities."""
    jfilt, filt, fr = stream["jfilt"], stream["filt"], stream["frames"]
    state = mid_state(stream, 10)
    assert int(state.gm.alive.sum()) > 20
    jst = jax_state(convert.to_numpy(state), jax.random.PRNGKey(0))
    z, zm = fr.z[10].astype(np.float32), fr.z_mask[10]
    jm, m = jfilt.meas, filt.meas
    if scan:
        jm = jm.with_scan(jnp.asarray(fr.scans[10], jnp.float32))
        m = m.with_scan(t(fr.scans[10], torch.float32))
    want = jfilt._map_update(jst, jnp.asarray(z), jnp.asarray(zm), jm)
    got = filt._map_update(state, t(z), t(zm), m)
    assert_gm_close(got[0], want[0])
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-5, atol=1e-5)
    for g, w in zip(got[2:4], want[2:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]),
                               rtol=1e-5)


def test_frames_match_jax_teacher_forced(stream):
    """The whole slice, teacher-forced: JAX runs frames 1-9 of the stream
    (with scans) frame by frame; at every frame the port starts from JAX's
    state with JAX's draws and must land on JAX's next state: immediate
    births, then candidates created and supported by the state machine,
    input-noise predicts, the general map update, the merge3d twin, prune
    and resampling.  Alive slots,
    candidates, ancestors and unused flags exact; poses rtol 1e-5 / atol
    1e-5 m, log-weights 1e-4, maps as assert_gm_close."""
    jfilt, filt, fr = stream["jfilt"], stream["filt"], stream["frames"]
    jicov = stream["jicov"]

    @jax.jit
    def jframe(state, pdt, pu, pnoise, z, zm, scan):
        # the JAX app's frame_step (apps/rbphdslam_victoriapark.py:160-182)
        meas = jfilt.meas.with_scan(scan)
        gm, birth = jfilt._add_birth_gaussians(state, state.particles.key,
                                               meas)
        state = state.replace(gm=gm, birth=birth)

        def substep(s, sub):
            dt, u, noise = sub
            return jfilt.predict(s, u, dt, use_model_noise=False,
                                 use_input_noise=noise, input_cov=jicov,
                                 birth_check=False, meas=meas), None

        state, _ = jax.lax.scan(substep, state, (pdt, pu, pnoise))
        return jfilt.update(state, z, zm, meas=meas)

    jst = jfilt.init_state(jax.random.PRNGKey(5), jnp.zeros(3), dz=3, d=3)
    dts = np.where(fr.pred_valid, fr.pred_dt, 0).astype(np.float32)
    launches = merge3d_mod.launches
    support = 0
    for j in range(10):
        args = (dts[j], fr.pred_u[j].astype(np.float32), fr.pred_noise[j],
                fr.z[j].astype(np.float32), fr.z_mask[j],
                fr.scans[j].astype(np.float32))
        want = jframe(jst, *args)
        key, draws = jst.particles.key, []
        for _ in range(len(dts[j])):
            key, d = predict_input_draws(key, P)
            draws.append(d)
        state = convert.from_numpy(RBPHDState, jst, CPU)
        got = app.step_frame(
            filt, state, filt.meas.with_scan(t(args[5])), dts[j],
            t(args[1]), args[2], stream["icov"], t(args[3]), t(args[4]),
            bool(args[4].any()), input_noise=t(np.stack(draws)),
            u0=t(resample_offset(key)))
        if j == 0:      # the first frame only births candidates
            continue
        np.testing.assert_array_equal(got.particles.parent.numpy(),
                                      np.asarray(want.particles.parent))
        np.testing.assert_allclose(got.particles.pose.numpy(),
                                   np.asarray(want.particles.pose),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.particles.log_w.numpy(),
                                   np.asarray(want.particles.log_w),
                                   rtol=1e-4, atol=1e-4)
        assert_gm_close(got.gm, want.gm)
        for f in ("alive", "n_support", "n_checks"):
            np.testing.assert_array_equal(getattr(got.birth, f).numpy(),
                                          np.asarray(getattr(want.birth, f)),
                                          err_msg=f)
        for name in ("last_unused", "n_in_fov", "n_updates", "n_meas"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)),
                                          err_msg=name)
        cand = np.asarray(want.birth.alive)
        support = max(support, int(np.asarray(want.birth.n_support)[cand]
                                   .max(initial=0)))
        jst = want
    assert merge3d_mod.launches == launches
    assert int(jst.gm.alive.sum()) > 0 and support >= 2


def test_update_at_origin_keeps_planes_finite(stream):
    """The JAX package's regression (tests/test_victoria_park.py::
    test_update_at_origin_keeps_planes_finite) on the port: a particle at
    the exact origin against dead slots parked there must leave every plane
    finite, births finite with Pd > 0, and a second update must lift a
    re-detected landmark above the birth weight."""
    cfg = XmlConfig(stream["cfg"])
    filt, _, _ = app.build(cfg, z_capacity=8, map_capacity=32, n_particles=2,
                           device=torch.device("cpu"))
    state = filt.init_state(torch.zeros(3), dz=3, d=3)
    z = torch.tensor([[20.46, 0.886, 0.354], [29.60, 1.021, 0.257],
                      [12.74, 1.353, 0.111]] + [[0.0, 0.0, 0.0]] * 5)
    z_mask = torch.tensor([True] * 3 + [False] * 5)
    state = filt.update(state, z, z_mask, u0=torch.tensor(0.5))
    assert torch.isfinite(state.gm.mean).all()
    assert torch.isfinite(state.gm.cov).all()
    assert int(state.last_unused[0].sum()) == 3
    gm, birth = filt._add_birth_gaussians(state)
    alive = gm.alive[0]
    assert int(alive.sum()) == 3
    assert torch.isfinite(gm.mean[:, 0, alive]).all()
    pd, _ = filt.meas.pd_p(state.particles.pose[:, None, :], gm.mean, gm.cov)
    assert float(pd[0][alive].max()) > 0.0
    state = dataclasses.replace(state, gm=gm, birth=birth)
    state = filt.update(state, z, z_mask, u0=torch.tensor(0.5))
    assert torch.isfinite(state.gm.mean).all()
    assert float(state.gm.w[0][state.gm.alive[0]].max()) > 0.5


def test_synthetic_stream(stream, tmp_path):
    """The stream's files load into frames of the dataset's shape: scans
    every 8 or 9 inputs, at most 24 detections, GPS on frame times, and
    the same seed writes the same files."""
    fr = stream["frames"]
    assert len(fr.t) == N_FRAMES and fr.scans.shape == (N_FRAMES, 361)
    n_sub = fr.pred_valid.sum(axis=1)
    assert set(n_sub[1:]) <= {9, 10}          # inputs + the scan's own step
    assert fr.z_mask.sum(axis=1).max() <= 24 and fr.z_mask.any(axis=1).all()
    assert np.isin(fr.gps[:, 0], fr.t).all()
    assert ((fr.scans > 0) & (fr.scans <= vp_synth.LASER_RANGE)).all()
    assert (fr.scans < vp_synth.LASER_RANGE).any()
    vp_synth.write(str(tmp_path), seed=0, n_frames=N_FRAMES, scans=True)
    for name in ("Sensors_manager.txt", "inputs.dat", "measurements.dat",
                 "gps.dat", "LASER.txt"):
        assert filecmp.cmp(tmp_path / name, stream["dir"] / name,
                           shallow=False), name


def test_app_runs_and_writes_logs(stream, tmp_path):
    """run with scans and artificial clutter stays finite; in chunks of 2
    frames (the checkpoint loop's, tests/test_torch_checkpoint.py) it
    gives the same outputs; main() on the CPU writes the reference-format
    logs."""
    filt, fr = stream["filt"], app.head(stream["frames"], 4)
    state, outs = app.run(filt, stream["icov"], fr,
                          torch.Generator().manual_seed(0),
                          artificial_clutter=2.0)
    assert outs["pose"].shape == (4, P, 3) and np.isfinite(outs["pose"]).all()
    assert np.isfinite(outs["w"]).all() and outs["alive"].any()
    _, chunked = app.run(filt, stream["icov"], fr,
                         torch.Generator().manual_seed(0),
                         artificial_clutter=2.0, ckpt_every=2)
    for k, v in outs.items():
        np.testing.assert_array_equal(chunked[k], v, err_msg=k)
    app.main(["--cfg", stream["cfg"], "--data", str(stream["dir"]),
              "--messages", "30", "--particles", "4", "--map-capacity", "32",
              "--device", "cpu", "--logdir", str(tmp_path)])
    for name in ("particlePose.dat", "landmarkEst.dat", "trajectory.dat"):
        assert (tmp_path / name).stat().st_size > 0


def test_build_runs_on_the_card_unless_asked_for_the_cpu(stream,
                                                         monkeypatch):
    """build() with no device targets CUDA: on a torch without CUDA it
    raises rather than return CPU tensors; with the CPU asked for, every
    tensor of the filter lies on the CPU."""
    cfg = XmlConfig(stream["cfg"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.build(cfg, map_capacity=32, n_particles=2)
    filt, icov, _ = app.build(cfg, map_capacity=32, n_particles=2,
                              device=torch.device("cpu"))
    # the filter's tensors and those of its models, one level down
    parts = list(vars(filt).values())
    for part in list(parts):
        parts += list(getattr(part, "__dict__", {}).values())
    tensors = [icov] + [t for t in parts if isinstance(t, torch.Tensor)]
    assert len(tensors) > 5
    assert {t.device.type for t in tensors} == {"cpu"}
