"""The port's 2-D simulation entry points: OSPA against the JAX package's,
analysis2dsim against the JAX app's files, and rbphdslam2dsim /
fastslam2dsim / batchsim on the CPU (``--device cpu``) with their configs
written in code (the reference XML is not in the repository).  Without a
card, each entry point refuses to run unless asked for the CPU."""

import dataclasses
import filecmp
import os
from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rfs_slam_tpu.apps import analysis2dsim as janalysis
from rfs_slam_tpu.apps import batchsim as jbatchsim
from rfs_slam_tpu.ops.ospa import ospa as jospa
from rfs_slam_tpu_torch.apps import analysis2dsim, batchsim, fastslam2dsim
from rfs_slam_tpu_torch.apps import rbphdslam2dsim
from rfs_slam_tpu_torch.io import sim2d_xml
from rfs_slam_tpu_torch.io.xmlconfig import XmlConfig, load_sim2d
from rfs_slam_tpu_torch.ops.ospa import ospa
from tests.torch_parity import t

CPU = ["--device", "cpu"]
# the tiny cell: 40 steps (inside the ground-truth lock), 8 landmarks
TINY = {"timesteps": 40, "landmarks.nLandmarks": 8}


@pytest.mark.parametrize("order", [1.0, 2.0])
def test_ospa_matches_jax(rng, order):
    for nx, ny in ((5, 7), (6, 6), (0, 3)):
        x = rng.uniform(0, 1, (6, 2)).astype(np.float32)
        y = rng.uniform(0, 1, (8, 2)).astype(np.float32)
        xm, ym = np.arange(6) < nx, np.arange(8) < ny
        want = jospa(jnp.asarray(x), jnp.asarray(xm), jnp.asarray(y),
                     jnp.asarray(ym), 0.2, order)
        got = ospa(t(x), t(xm), t(y), t(ym), 0.2, order)
        for g, w, name in zip(got, want, want._fields):
            np.testing.assert_allclose(g.item(), float(w), rtol=1e-5,
                                       atol=1e-6, err_msg=name)


def write_fake_logs(d, T=5, P=3):
    """tests/test_analysis.py::_write_fake_logs: a reference-format log
    directory whose best particle sits at the groundtruth plus jitter."""
    rng = np.random.default_rng(0)
    tt = np.arange(1, T + 1) * 0.1
    gt = np.stack([tt, tt, 0.5 * tt, np.zeros(T)], axis=1)
    lmk = np.array([[1.0, 0.0, 0.1], [0.0, 1.0, 0.3]])
    os.makedirs(d, exist_ok=True)
    np.savetxt(os.path.join(d, "gtPose.dat"), gt)
    np.savetxt(os.path.join(d, "deadReckoning.dat"),
               gt[:, :4] + [0, 0.05, -0.05, 0.01])
    np.savetxt(os.path.join(d, "gtLandmark.dat"), lmk)
    with open(os.path.join(d, "particlePose.dat"), "w") as f:
        for k in range(T):
            for i in range(P):
                x = gt[k, 1] + 0.01 * i
                w = 1.0 if i == 1 else 0.2
                f.write(f"{tt[k]:.6f} {i} {x:.6f} {gt[k, 2]:.6f} 0.0 {w}\n")
    with open(os.path.join(d, "landmarkEst.dat"), "w") as f:
        for k in range(T):
            for lx, ly, _ in lmk:
                jx = lx + rng.normal(scale=0.01)
                f.write(f"{tt[k]:.6f} 1 {jx:.6f} {ly:.6f} "
                        f"0.01 0.0 0.01 0.9\n")


OUTPUTS = ("poseEstError.dat", "deadReckoningError.dat",
           "landmarkEstError.dat")


def test_analysis2dsim_writes_the_jax_apps_files(tmp_path):
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    write_fake_logs(mine)
    write_fake_logs(theirs)
    analysis2dsim.main([mine])
    janalysis.main([theirs])
    for name in OUTPUTS:
        assert filecmp.cmp(os.path.join(mine, name),
                           os.path.join(theirs, name), shallow=False), name
    me = np.loadtxt(os.path.join(mine, "landmarkEstError.dat"))
    assert me[-1, 1] == 2 and me[-1, 3] < 1.0


def config(tmp_path, kind, **extra):
    return sim2d_xml.write_config(str(tmp_path / f"{kind}.xml"), kind,
                                  {**TINY, **extra})


@pytest.mark.parametrize("app,kind,particles,steps", [
    (rbphdslam2dsim, "rbphd", 4, 40), (fastslam2dsim, "fastslam", 4, 40),
    (fastslam2dsim, "mhfastslam", 2, 16)])
def test_main_writes_logs_on_cpu(tmp_path, app, kind, particles, steps):
    """The app on --device cpu writes the reference-format logs of every
    step, which analysis2dsim then reads."""
    d = str(tmp_path / "logs")
    cfg = config(tmp_path, kind)
    app.main(["--cfg", cfg, "--trajectory", "1", "--seed", "1", "--logdir",
              d, "--particles", str(particles), "--steps", str(steps), *CPU])
    pp = np.loadtxt(os.path.join(d, "particlePose.dat"))
    P = particles * (3 if kind == "mhfastslam" else 1)
    # the t=0 block, then one per step
    assert pp.shape == (steps * P, 6) and np.isfinite(pp).all()
    le = np.loadtxt(os.path.join(d, "landmarkEst.dat"), ndmin=2)
    assert le.shape[1] == 8 and len(le) > 0
    assert os.path.exists(os.path.join(d, "simSettings.xml"))
    analysis2dsim.main([d])
    pe = np.loadtxt(os.path.join(d, "poseEstError.dat"))
    # inside the ground-truth lock the best particle is on the groundtruth
    assert pe.shape == (steps - 1, 5) and np.abs(pe[:, 4]).max() < 1e-4


@pytest.mark.parametrize("kind", ["rbphd", "fastslam"])
def test_batchsim_run_one_on_cpu(tmp_path, kind):
    """One tiny sweep cell through the filter of each kind (the JAX
    package's batchsim smoke test, with its config written in code)."""
    cfg = XmlConfig(config(tmp_path, "rbphd" if kind == "rbphd"
                           else "fastslam"))
    sim_cfg = dataclasses.replace(load_sim2d(cfg), timesteps=40,
                                  n_landmarks=8)
    mean_err, final_err, map_err, wall = batchsim.run_one(
        kind, cfg, sim_cfg, traj_seed=1, noise_seed=1, z_capacity=8,
        n_particles=4, device=torch.device("cpu"))
    assert np.isfinite([mean_err, final_err, map_err, wall]).all()
    assert map_err >= 0.0 and mean_err < 5.0


@pytest.mark.parametrize("kind,case", [("rbphd", "mixed"),
                                       ("fastslam", "mixed"),
                                       ("rbphd", "no weight reaches 0.75")])
def test_final_map_cola_matches_jax(rng, kind, case):
    """Both packages' batchsim.final_map_cola on the same final maps: the
    best map's landmarks with w >= 0.75 (log-odds for FastSLAM) against
    the landmarks observed by the last step.  With no weight at 0.75 the
    COLA is the count of observed landmarks (50.0 at the stand-in XML's
    defaults in both packages)."""
    T, M, L = 3, 24, 14
    first = rng.uniform(-1.0, 12.0, L)
    first[:3] = -1.0                        # never observed
    data = SimpleNamespace(landmarks=rng.uniform(-5, 5, (L, 2)),
                           lmk_first_obs=first)
    sim_cfg = SimpleNamespace(timesteps=101, dt=0.1)   # t_end 10 s
    mean = rng.uniform(-5, 5, (T, M, 2)).astype(np.float32)
    mean[-1, :L] = data.landmarks + rng.normal(0, 0.05, (L, 2))
    w = (rng.uniform(0.0, 1.0, (T, M)) if kind == "rbphd"
         else rng.normal(0.0, 2.0, (T, M))).astype(np.float32)
    if case != "mixed":
        w[:] = 0.5
    alive = rng.random((T, M)) < 0.8
    want = jbatchsim.final_map_cola(kind, data, sim_cfg, mean, w, alive)
    got = batchsim.final_map_cola(kind, data, sim_cfg, mean, w, alive)
    assert got == want
    if case != "mixed":
        assert got == float(((first >= 0) & (first <= 10.0)).sum())


def test_batchsim_main_on_cpu(tmp_path):
    out = str(tmp_path / "results.dat")
    batchsim.main(["--cfg", config(tmp_path, "fastslam"), "--filter",
                   "fastslam", "--pd", "0.9", "--clutter", "1e-3",
                   "--seeds", "1", "--steps", "30", "--particles", "2",
                   "--zc", "8", "--out", out, *CPU])
    rows = np.loadtxt(out, ndmin=2)
    assert rows.shape == (1, 7) and np.isfinite(rows).all()


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_entry_points_need_the_card_unless_asked_for_the_cpu(tmp_path):
    cfg = config(tmp_path, "fastslam")
    for app in (rbphdslam2dsim, fastslam2dsim):
        with pytest.raises(RuntimeError, match="CUDA"):
            app.main(["--cfg", cfg])
        with pytest.raises(RuntimeError, match="CUDA"):
            app.build_filter_from_xml(XmlConfig(cfg),
                                      load_sim2d(XmlConfig(cfg)), 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        batchsim.run_one("fastslam", XmlConfig(cfg),
                         load_sim2d(XmlConfig(cfg)), 1, 1, 8, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        batchsim.main(["--cfg", cfg, "--out", str(tmp_path / "r.dat")])
