"""The port's Victoria Park FastSLAM 1.0 / MH-FastSLAM against the JAX
package, on the same synthetic stream and config: the app's ``build``, and
the whole slice at D=3 teacher-forced over consecutive frames with scans
(the VictoriaPark model's multi-probe Pd with covariance, its scan-dependent
clutter, its three gates), for FastSLAM 1.0, MH-FastSLAM (H=3, grow mode,
the gated Murty), the landmark-candidate state machine and a map of 8 slots
that fills and recycles its weakest; then the app's command line on the
CPU.

Discrete outputs (parents, alive flags, the candidates' alive / n_support /
n_checks, counters) are equal; poses rtol 1e-5 / atol 1e-5 m, log-weights
rtol 1e-4 / atol 1e-4, maps as ``assert_gm_close``.  One exception, counted
and held to at most one slot a run: a resampling slot whose comb position
lies within 1e-6 of a cumulative-weight boundary (:func:`tied_slots`).  At
MH frame 3 one does, 4.6e-9 from it: JAX puts the slot on one side under
XLA's default optimisation (as the port does) and on the other under the
tests' level 0."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rfs_slam_tpu.apps import fastslam_victoriapark as japp
from rfs_slam_tpu.io.xmlconfig import XmlConfig as JXmlConfig
from rfs_slam_tpu_torch import convert
from rfs_slam_tpu_torch.apps import fastslam_victoriapark as app
from rfs_slam_tpu_torch.filters import fastslam as pfs
from rfs_slam_tpu_torch.io import victoria_park as vp_io
from rfs_slam_tpu_torch.io import vp_synth
from rfs_slam_tpu_torch.io.xmlconfig import XmlConfig
from rfs_slam_tpu_torch.core.state import GMState
from rfs_slam_tpu_torch.ops import gm as gm_ops
from rfs_slam_tpu_torch.ops import resample as resample_ops
from tests.torch_parity import (CPU, assert_gm_close, fastslam_input_draws,
                                host, jax_gm, resample_offset, t)

P, M = 8, 64
N_FRAMES = 12
FRAMES = {"h1": 10, "mh": 6, "candidates": 6, "recycle": 8}  # compared
VARIANTS = {"h1": {}, "mh": {"hypotheses": 3},
            "candidates": {"cand_count_threshold": 2},
            "recycle": {"map_capacity": 8}}


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    """A synthetic stream with scans and its config (the Pd table; every
    other key at the app's defaults)."""
    d = tmp_path_factory.mktemp("vpfs")
    assert vp_synth.write(str(d), seed=0, n_frames=N_FRAMES, scans=True) == 0
    cfg = vp_synth.write_config(str(d / "config.xml"))
    return dict(dir=d, cfg=cfg)


def jax_build(stream, name):
    """The JAX app's filter of a variant at P=8, M=64 (unless the variant
    sets the map capacity)."""
    v = {"map_capacity": M, **VARIANTS[name]}
    cand = v.pop("cand_count_threshold", None)
    jfilt, jicov, ack = japp.build(JXmlConfig(stream["cfg"]), z_capacity=24,
                                   n_particles=P, **v)
    if cand is not None:
        jfilt = type(jfilt)(jfilt.motion, jfilt.lmk, jfilt.meas, jfilt.gates,
                            dataclasses.replace(jfilt.cfg,
                                                cand_count_threshold=cand))
    return jfilt, jicov, ack


def port_build(stream, name):
    v = {"map_capacity": M, **VARIANTS[name]}
    cand = v.pop("cand_count_threshold", None)
    filt, icov, ack = app.build(XmlConfig(stream["cfg"]), n_particles=P,
                                device=torch.device("cpu"), **v)
    if cand is not None:
        filt = pfs.FastSLAMFilter(filt.motion, filt.lmk, filt.meas,
                                  filt.gates, dataclasses.replace(
                                      filt.cfg, cand_count_threshold=cand))
    return filt, icov, ack


@pytest.mark.parametrize("name", ["h1", "mh"])
def test_port_build_matches_converted_jax_build(stream, name):
    """The port's build reads the JAX app's keys and defaults: its filter
    equals the JAX filter carried across by convert.py, for H=1 and H=3
    (the lane budget "auto": n_particles)."""
    jfilt, jicov, jack = jax_build(stream, name)
    filt, icov, ack = port_build(stream, name)
    conv = convert.filter_from_numpy(jfilt, CPU)
    assert filt.cfg == conv.cfg and filt.gates == conv.gates
    assert filt.p_cap == jfilt.p_cap == (3 * P if name == "mh" else P)
    assert filt.cfg.murty_lane_budget == P and filt.cfg.nmz_capacity == 32
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
    np.testing.assert_array_equal(icov.numpy(),
                                  np.asarray(jicov, np.float32))
    assert ack == jack


def jax_frame(jfilt, jicov):
    """The JAX app's frame_step (apps/fastslam_victoriapark.py:166-180),
    jitted once."""
    @jax.jit
    def frame(state, pdt, pu, pnoise, z, zm, scan):
        meas = jfilt.meas.with_scan(scan)

        def substep(s, sub):
            dt, u, noise = sub
            return jfilt.predict(s, u, dt, use_model_noise=False,
                                 use_input_noise=noise,
                                 input_cov=jicov), None

        state, _ = jax.lax.scan(substep, state, (pdt, pu, pnoise))
        return jfilt.update(state, z, zm, meas=meas)
    return frame


def rows(d, keep):
    """The particle rows ``keep`` of a state dict: planes (``mean``,
    ``cov``) carry the particle axis second, every other array first."""
    return {k: rows(v, keep) if isinstance(v, dict) else
            v if v.ndim == 0 else v[:, keep] if k in ("mean", "cov")
            else v[keep] for k, v in d.items()}


def tied_slots(call):
    """Slots whose systematic-comb position ``(u0 + i) / n`` lies within
    1e-6 of a boundary of the port's cumulative weights (recorded
    ``call``): a float tie whose side the last bits decide.  JAX decides
    such a tie differently under XLA's default optimisation and the tests'
    level 0, so the ancestor of a tied slot is not compared."""
    if call is None:
        return np.zeros(0, np.int64)
    u0, log_w, n = call
    w = torch.exp(log_w - torch.logsumexp(log_w, dim=0))
    cum = torch.cumsum(w, dim=0).numpy()
    pts = ((u0 + torch.arange(n, dtype=log_w.dtype)) / n).numpy()
    gap = np.abs(pts[:, None] - cum[None, :]).min(axis=1)
    return np.flatnonzero(gap < 1e-6)


def assert_frame_matches(got, want, tied=()):
    """Parents exact on every untied slot; on the slots that hold the same
    ancestor in both, the state at the tolerances of the module doc."""
    g, w = host(got), host(want)
    gp, wp = g["particles"]["parent"], w["particles"]["parent"]
    differ = np.flatnonzero(gp != wp)
    assert set(differ) <= set(tied), (differ, tied, gp, wp)
    keep = np.flatnonzero(gp == wp)
    g, w = rows(g, keep), rows(w, keep)
    lw = w["particles"]["log_w"]
    live = np.isfinite(lw)
    np.testing.assert_array_equal(np.isfinite(g["particles"]["log_w"]), live)
    np.testing.assert_allclose(g["particles"]["pose"][live],
                               w["particles"]["pose"][live], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(g["particles"]["log_w"][live], lw[live],
                               rtol=1e-4, atol=1e-4)
    assert_gm_close(GMState(**{k: torch.as_tensor(v)
                               for k, v in g["gm"].items()}),
                    jax_gm(w["gm"]))
    for f in ("alive", "n_support", "n_checks"):
        np.testing.assert_array_equal(g["cand"][f], w["cand"][f], err_msg=f)
    a = w["cand"]["alive"]
    np.testing.assert_allclose(g["cand"]["mean"][:, a],
                               w["cand"]["mean"][:, a], rtol=1e-4,
                               atol=1e-5)
    for name in ("n_in_fov", "n_updates", "n_meas"):
        np.testing.assert_array_equal(g[name], w[name], err_msg=name)


@pytest.mark.parametrize("name", ["h1", "mh", "candidates", "recycle"])
def test_frames_match_jax_teacher_forced(stream, name, monkeypatch):
    """The whole slice at D=3, teacher-forced: JAX runs the stream's frames
    (with scans) frame by frame; at every frame the port starts from JAX's
    state with JAX's draws (the input noise of every predict substep, the
    resampling offset) and must land on JAX's next state.  FastSLAM 1.0
    runs 10 frames; MH-FastSLAM 6, at least 3 of them with a lane whose
    gated Murty kept a second hypothesis; the candidate state machine
    (count threshold 2) 6, with candidates born, checked and expired (none
    gains a second support on this stream, in JAX as in the port: the
    support gate is one sigma of the 3-D innovation); FastSLAM 1.0 with a
    map of 8 slots 8, where the maps fill and births displace live
    landmarks (``replace_weakest`` on a full map)."""
    jfilt, jicov, ack = jax_build(stream, name)
    filt, icov, _ = port_build(stream, name)
    fr = vp_io.load(str(stream["dir"]), z_capacity=24, ackerman=ack)
    jframe = jax_frame(jfilt, jicov)
    n_hyp = []
    murty_gated = pfs.murty_gated

    def spy(*a, **k):
        das, scores, valid = murty_gated(*a, **k)
        n_hyp.append(int(valid.sum(dim=1).max()))
        return das, scores, valid

    monkeypatch.setattr(pfs, "murty_gated", spy)
    comb = []
    systematic = resample_ops.systematic_ancestors

    def comb_spy(u0, log_w, n):
        comb.append((u0, log_w, n))
        return systematic(u0, log_w, n)

    monkeypatch.setattr(resample_ops, "systematic_ancestors", comb_spy)
    recycled = []
    replace_weakest = gm_ops.replace_weakest

    def replace_spy(gm, *a, **k):
        out = replace_weakest(gm, *a, **k)
        moved = (gm.mean != out.mean).any(dim=0)
        recycled.append(int((gm.alive & out.alive & moved).sum()))
        return out

    monkeypatch.setattr(gm_ops, "replace_weakest", replace_spy)
    jst = jfilt.init_state(jax.random.PRNGKey(5), jnp.zeros(3), d=3)
    dts = np.where(fr.pred_valid, fr.pred_dt, 0).astype(np.float32)
    born, checks, ties = 0, 0, 0
    for j in range(FRAMES[name]):
        args = (dts[j], fr.pred_u[j].astype(np.float32), fr.pred_noise[j],
                fr.z[j].astype(np.float32), fr.z_mask[j],
                fr.scans[j].astype(np.float32))
        want = jframe(jst, *args)
        key, draws = jst.particles.key, []
        for _ in range(len(dts[j])):
            key, d = fastslam_input_draws(key, filt.p_cap)
            draws.append(d)
        state = convert.from_numpy(pfs.FastSLAMState, jst, CPU)
        comb.clear()
        got = app.step_frame(
            filt, state, filt.meas.with_scan(t(args[5])), dts[j],
            t(args[1]), args[2], icov, t(args[3]), t(args[4]),
            bool(args[4].any()), input_noise=t(np.stack(draws)),
            u0=t(resample_offset(key)))
        tied = tied_slots(comb[-1] if comb else None)
        ties += len(tied)
        assert_frame_matches(got, want, tied)
        cand = np.asarray(want.cand.alive)
        born += int(cand.sum())
        checks = max(checks, int(np.asarray(want.cand.n_checks)[cand]
                                 .max(initial=0)))
        jst = want
    assert int(jst.gm.alive.sum()) > 0 and ties <= 1
    if name == "mh":
        assert sum(h > 1 for h in n_hyp) >= 3, n_hyp
    if name == "candidates":
        assert born > 0 and checks >= 2
    if name == "recycle":
        assert bool(np.asarray(jst.gm.alive).all()) and sum(
            r > 0 for r in recycled) >= FRAMES[name] // 2, \
            recycled


def test_app_main_writes_logs_and_build_needs_the_card(stream, tmp_path,
                                                       monkeypatch):
    """main() on the CPU writes the three reference-format logs (P=4,
    MH-FastSLAM); build() with no device targets CUDA and raises on a torch
    without it, and with the CPU asked for every tensor lies there."""
    app.main(["--cfg", stream["cfg"], "--data", str(stream["dir"]),
              "--messages", "40", "--particles", "4", "--map-capacity", "32",
              "--hypotheses", "3", "--device", "cpu", "--logdir",
              str(tmp_path)])
    for name in ("particlePose.dat", "landmarkEst.dat", "trajectory.dat"):
        assert (tmp_path / name).stat().st_size > 0
    rows = np.loadtxt(tmp_path / "particlePose.dat", ndmin=2)
    assert np.isfinite(rows).all()

    cfg = XmlConfig(stream["cfg"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.build(cfg, map_capacity=32, n_particles=2)
    filt, icov, _ = app.build(cfg, map_capacity=32, n_particles=2,
                              device=torch.device("cpu"))
    parts = list(vars(filt).values())
    for part in list(parts):
        parts += list(getattr(part, "__dict__", {}).values())
    tensors = [icov] + [x for x in parts if isinstance(x, torch.Tensor)]
    assert len(tensors) > 5
    assert {x.device.type for x in tensors} == {"cpu"}


def test_vp_map_ospa_matches_jax(tmp_path, rng):
    """The cross-run OSPA / COLA of two landmarkEst.dat files (one with
    log-odds weights) equals the JAX app's on the same files and options:
    the same final maps, OSPA, its parts and COLA to 1e-5."""
    from rfs_slam_tpu.apps import vp_map_ospa as jospa_app
    from rfs_slam_tpu.ops.ospa import ospa as jospa
    from rfs_slam_tpu_torch.apps import vp_map_ospa as ospa_app
    from rfs_slam_tpu_torch.io import logs

    T, M = 3, 60
    times = np.arange(T) * 0.5
    trees = rng.uniform(-30, 30, (M, 2))
    paths = []
    for name, log_odds in (("a", False), ("b", True)):
        mean = trees[None] + rng.normal(0, 0.8, (T, M, 2))
        w = (rng.normal(1.0, 2.0, (T, M)) if log_odds
             else rng.uniform(0.3, 1.0, (T, M)))
        alive = rng.uniform(size=(T, M)) < 0.8
        logs.write_landmark_estimates(str(tmp_path / name), times,
                                      np.zeros(T, int), mean,
                                      rng.uniform(0.1, 0.5, (T, M, 3)), w,
                                      alive)
        paths.append(str(tmp_path / name / "landmarkEst.dat"))
    for cutoff, order in ((5.0, 1.0), (2.0, 2.0)):
        a = ospa_app.load_final_map(paths[0], 0.75, False)
        b = ospa_app.load_final_map(paths[1], 0.75, True)
        ja = jospa_app.load_final_map(paths[0], 0.75, False)
        jb = jospa_app.load_final_map(paths[1], 0.75, True)
        np.testing.assert_array_equal(a, ja)
        np.testing.assert_array_equal(b, jb)
        assert len(a) > 10 and len(b) > 10 and len(a) != len(b)
        got = ospa_app.main([*paths, "--cutoff", str(cutoff), "--order",
                             str(order), "--log-odds-b", "--device", "cpu"])
        want = jospa(jnp.asarray(ja, jnp.float32),
                     jnp.ones((len(ja),), bool),
                     jnp.asarray(jb, jnp.float32),
                     jnp.ones((len(jb),), bool), cutoff=cutoff, order=order)
        for k in ("ospa", "loc", "card", "cola"):
            np.testing.assert_allclose(got[k], float(getattr(want, k)),
                                       rtol=1e-5, atol=1e-5, err_msg=k)


def test_convertlogfiles_matches_jax(tmp_path):
    """The legacy-log converter writes JAX's bytes from a hand-written
    old-format particlePose.dat and landmarkEst.dat, and keeps the old
    files as .bak."""
    from rfs_slam_tpu.apps import convertlogfiles as jconv
    from rfs_slam_tpu_torch.apps import convertlogfiles as conv

    poses = ("Timesteps: 2\nk = 0.1\nnParticles = 2\n1.0 2.0 0.5 0.25\n"
             "1.5 2.5 -0.5 0.75\nk = 0.2\nnParticles = 2\n"
             "1.1 2.1 0.6 0.5\n1.6 2.6 -0.4 0.5\n")
    lms = ("Timesteps: 2\nnParticles: 2\n"
           "Timestep: 0.1   Particle: 0   Map Size: 2\n"
           "3.0 4.0 0.1 0.01 0.01 0.2 0.9\n5.0 6.0 0.3 0.02 0.02 0.4 0.8\n"
           "\nTimestep: 0.2   Particle: 1   Map Size: 1\n"
           "7.0 8.0 0.5 0.03 0.03 0.6 0.7\n")
    for name, mod in (("port", conv), ("jax", jconv)):
        d = tmp_path / name
        d.mkdir()
        (d / "particlePose.dat").write_text(poses)
        (d / "landmarkEst.dat").write_text(lms)
        assert mod.main([str(d)]) == 0
        assert (d / "particlePose.bak").read_text() == poses
    for name in ("particlePose.dat", "landmarkEst.dat"):
        got = (tmp_path / "port" / name).read_bytes()
        assert got == (tmp_path / "jax" / name).read_bytes(), name
        assert got.count(b"\n") == (4 if name == "particlePose.dat" else 3)


def test_phase_timer_and_profile_flag_match_jax(tmp_path):
    """profile_phases times the JAX package's phases (its names, in its
    order, read from its source) and rbphdslam2dsim --profile writes
    timing.dat with the JAX writer's header and columns."""
    import inspect
    import re

    from rfs_slam_tpu.io import logs as jlogs
    from rfs_slam_tpu.utils import timing as jtiming
    from rfs_slam_tpu_torch.apps import rbphdslam2dsim
    from rfs_slam_tpu_torch.io import sim2d_xml

    names = re.findall(r'timer\.time\("(\w+)"',
                       inspect.getsource(jtiming.profile_phases))
    cfg = sim2d_xml.write_config(str(tmp_path / "rb.xml"), "rbphd")
    rbphdslam2dsim.main(["--cfg", cfg, "--steps", "12", "--particles", "4",
                         "--device", "cpu", "--profile", "--logdir",
                         str(tmp_path / "port")])
    rows = (tmp_path / "port" / "timing.dat").read_text().splitlines()
    # the source lists the pass's seven phases, then the fullStep anchor,
    # which is timed first
    assert len(names) == 8 and names[-1] == "fullStep"
    assert [r.split()[0] for r in rows[1:]] == [names[-1]] + names[:-1]
    timer = jtiming.PhaseTimer()
    for n in names:
        timer.time(n, lambda: jnp.zeros(1))
    jlogs.write_timing(str(tmp_path / "jax"), timer.report())
    jrows = (tmp_path / "jax" / "timing.dat").read_text().splitlines()
    assert rows[0] == jrows[0]
    assert [len(r.split()) for r in rows] == [len(r.split()) for r in jrows]
    assert all(int(v) >= 0 for r in rows[1:] for v in r.split()[1:])
