"""The port's native I/O (rfs_slam_tpu_torch/io/native.py over
native/rfsio.cpp, built with g++ at first use): the native writers against
the port's Python writers, byte for byte, NaNs of either sign included;
the port's Python writers against the JAX package's on the same inputs;
the native loadtxt against numpy; and the Victoria Park loader with and
without the library."""

import ctypes
import dataclasses
import os

import numpy as np
import pytest

from rfs_slam_tpu.io import logs as jlogs
from rfs_slam_tpu.io import native as jnative
from rfs_slam_tpu_torch.io import logs, native, victoria_park, vp_synth


@pytest.fixture
def no_jax_native(monkeypatch):
    """The JAX package's Python writers (its library unloaded)."""
    monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(jnative, "_TRIED", True)


@pytest.fixture
def no_port_native(monkeypatch):
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", True)


def log_inputs(seed=0, T=6, P=5, M=7, specials=True):
    rng = np.random.default_rng(seed)
    times = (np.arange(1, T + 1) * 0.1).astype(np.float32)
    poses = rng.normal(size=(T, P, 3)).astype(np.float32)
    weights = rng.random((T, P)).astype(np.float32)
    best = rng.integers(0, P, T)
    means = rng.normal(size=(T, M, 3)).astype(np.float32)
    covs = rng.random((T, M, 3)).astype(np.float32)
    ws = rng.normal(size=(T, M)).astype(np.float32)
    alive = rng.random((T, M)) < 0.7
    if specials:
        neg_nan = np.float32(np.copysign(np.nan, -1.0))
        poses[0, 0, 0], poses[0, 1, 0] = np.nan, neg_nan
        poses[1, 0, 1], poses[1, 1, 1] = np.inf, -np.inf
        poses[2, 0, 0], poses[2, 0, 1] = -0.0, -1e-9
        weights[3, 2] = neg_nan
        covs[0, :, 1] = neg_nan
        ws[1] = -np.inf
        alive[0] = True
    return times, poses, weights, best, means, covs, ws, alive


def packed_args(inputs):
    times, poses, weights, best, means, covs, ws, alive = inputs
    return (times, poses, weights), (times, best, means[..., :2], covs, ws,
                                     alive)


def read(logdir):
    return {name: open(os.path.join(logdir, name), "rb").read()
            for name in ("particlePose.dat", "landmarkEst.dat")}


def write_with(poses_fn, landmarks_fn, logdir, inputs):
    """Both files through the given writers (``fn(path, *args)``)."""
    os.makedirs(logdir, exist_ok=True)
    pp, lm = packed_args(inputs)
    assert poses_fn(os.path.join(logdir, "particlePose.dat"), *pp) in (
        None, True)
    assert landmarks_fn(os.path.join(logdir, "landmarkEst.dat"), *lm) in (
        None, True)
    return read(logdir)


def write_native(logdir, inputs):
    return write_with(native.write_particle_poses,
                      native.write_landmark_estimates, logdir, inputs)


def write_python(logdir, inputs):
    return write_with(logs.python_particle_poses,
                      logs.python_landmark_estimates, logdir, inputs)


def write_logs(mod, logdir, inputs):
    """The package's ``write_*`` entry points."""
    times, poses, weights, best, means, covs, ws, alive = inputs
    mod.write_particle_poses(logdir, times, poses, weights)
    mod.write_landmark_estimates(logdir, times, best, means, covs, ws, alive)
    return read(logdir)


def test_library_builds_outside_the_jax_packages_directory():
    assert native.lib() is not None, "g++ is here: the library must build"
    path = native.library_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(os.path.dirname(os.path.dirname(path))) == "build"


@pytest.mark.parametrize("seed,specials", [(0, True), (1, True), (2, False)])
def test_native_writers_equal_python_writers(tmp_path, seed, specials):
    inputs = log_inputs(seed, specials=specials)
    nat = write_native(str(tmp_path / "nat"), inputs)
    py = write_python(str(tmp_path / "py"), inputs)
    for name in nat:
        assert nat[name] == py[name], name
    assert write_logs(logs, str(tmp_path / "logs"), inputs) == nat
    rows = nat["landmarkEst.dat"].decode().splitlines()
    assert len(rows) == int(inputs[-1].sum())
    if specials:
        text = nat["particlePose.dat"].decode()
        assert " nan " in text and "-nan" not in text and " inf " in text


def test_c_prints_the_sign_of_nan(tmp_path):
    """Why the writers clear NaN sign bits: C's %f prints ``-nan`` where
    Python prints ``nan``."""
    L = native.lib()
    poses = np.zeros((1, 1, 3))
    poses[0, 0, 0] = np.copysign(np.nan, -1.0)
    one = np.ones(1)
    path = str(tmp_path / "p.dat")
    dp = ctypes.POINTER(ctypes.c_double)
    assert L.rfsio_write_particle_poses(
        path.encode(), one.ctypes.data_as(dp), poses.ctypes.data_as(dp),
        one.ctypes.data_as(dp), 1, 1) == 0
    assert "-nan" in open(path).read()
    assert "%f" % poses[0, 0, 0] == "nan"


@pytest.mark.parametrize("seed", [0, 3])
def test_python_writers_equal_jax_writers(tmp_path, no_jax_native, seed):
    inputs = log_inputs(seed)
    ours = write_python(str(tmp_path / "port"), inputs)
    theirs = write_logs(jlogs, str(tmp_path / "jax"), inputs)
    assert ours == theirs
    # dense [T, M, 2, 2] covariances take the same rows
    times, poses, weights, best, means, covs, ws, alive = inputs
    dense = np.zeros(covs.shape[:2] + (2, 2), np.float32)
    dense[..., 0, 0], dense[..., 1, 1] = covs[..., 0], covs[..., 2]
    dense[..., 0, 1] = dense[..., 1, 0] = covs[..., 1]
    logs.write_landmark_estimates(str(tmp_path / "dense"), times, best,
                                  means, dense, ws, alive)
    assert (open(tmp_path / "dense" / "landmarkEst.dat", "rb").read()
            == theirs["landmarkEst.dat"])


def test_native_loadtxt_matches_numpy(tmp_path):
    rng = np.random.default_rng(1)
    for shape, fmt in (((50, 4), "%.18e"), ((7, 3), "%f"), ((1, 5), "%g")):
        p = str(tmp_path / f"v{shape[0]}.dat")
        np.savetxt(p, rng.normal(size=shape) * 100, fmt=fmt)
        np.testing.assert_array_equal(native.loadtxt(p),
                                      np.loadtxt(p, ndmin=2))
        np.testing.assert_array_equal(native.read_values(p),
                                      np.loadtxt(p).ravel())


def test_vp_loader_equal_with_and_without_library(tmp_path, monkeypatch):
    d = str(tmp_path)
    vp_synth.write(d, seed=0, n_frames=40, scans=True)
    with_lib = victoria_park.load(d, z_capacity=24)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", True)
    without = victoria_park.load(d, z_capacity=24)
    for f in dataclasses.fields(with_lib):
        a, b = getattr(with_lib, f.name), getattr(without, f.name)
        if a is None:
            assert b is None, f.name
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)


def test_writers_fall_back_without_library(tmp_path, no_port_native):
    inputs = log_inputs(4)
    assert not native.write_particle_poses(str(tmp_path / "x"), *inputs[:3])
    assert native.loadtxt(str(tmp_path / "x")) is None
    out = write_logs(logs, str(tmp_path / "fb"), inputs)
    assert out == write_python(str(tmp_path / "py"), inputs)
