"""Checkpoint / resume of the port's Victoria Park runs on the CPU: the port's
version of tests/test_victoria_park.py::test_checkpoint_resume_bit_identical
for both apps (RB-PHD and FastSLAM), the snapshot format
(``utils/checkpoint.py``: rotation, atomic writes, template checks, the
generator's state) and the chunked loop (``apps/_vp_common.py``:
``resume_at``, ``reseed``, missing output chunks), and the FastSLAM app's
command line continuing a cut run to the same logs.

Every comparison is bit for bit: float arrays as their int32 views."""

import dataclasses
import filecmp
import os

import numpy as np
import pytest
import torch

from rfs_slam_tpu_torch.apps import _vp_common
from rfs_slam_tpu_torch.apps import fastslam_victoriapark as fs_app
from rfs_slam_tpu_torch.apps import rbphdslam_victoriapark as rb_app
from rfs_slam_tpu_torch.io import victoria_park as vp_io
from rfs_slam_tpu_torch.io import vp_synth
from rfs_slam_tpu_torch.io.xmlconfig import XmlConfig
from rfs_slam_tpu_torch.utils import checkpoint
from tests.torch_parity import CPU, host

N_FRAMES = 12
APPS = {"rbphd": rb_app, "fastslam": fs_app}


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    """A 12-frame synthetic stream with scans, its config, and each app's
    filter on it (P=4, M=32)."""
    d = tmp_path_factory.mktemp("vpck")
    assert vp_synth.write(str(d), seed=0, n_frames=N_FRAMES, scans=True) == 0
    cfg = vp_synth.write_config(str(d / "config.xml"))
    built = {k: m.build(XmlConfig(cfg), map_capacity=32, n_particles=4,
                        device=CPU) for k, m in APPS.items()}
    return dict(dir=d, cfg=cfg, built=built, frames=vp_io.load(
        str(d), z_capacity=24, ackerman=built["rbphd"][2]))


def bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_same(a, b, where=""):
    """Equal bit for bit: output dicts, state dicts, nested."""
    assert a.keys() == b.keys(), where
    for k in a:
        if isinstance(a[k], dict):
            assert_same(a[k], b[k], f"{where}.{k}")
        else:
            np.testing.assert_array_equal(bits(a[k]), bits(b[k]),
                                          err_msg=f"{where}.{k}")


def run(stream, kind, **kw):
    filt, icov, _ = stream["built"][kind]
    frames = kw.pop("frames", stream["frames"])
    return APPS[kind].run(filt, icov, frames,
                          torch.Generator().manual_seed(3),
                          artificial_clutter=1.0, progress=False, **kw)


@pytest.fixture(scope="module")
def unbroken(stream):
    """Each app's run over the whole stream in one chunk."""
    return {k: run(stream, k) for k in APPS}


@pytest.mark.parametrize("kind", ["rbphd", "fastslam"])
def test_checkpoint_resume_bit_identical(stream, unbroken, kind, tmp_path):
    """A run cut after its first chunk (6 of 12 frames) and resumed from the
    snapshot gives the unbroken run's outputs and final state bit for bit;
    the snapshot holds the generator, so the resumed draws are the
    unbroken run's.  No ``.tmp`` file is left behind."""
    d = str(tmp_path / "ckpt")
    half = N_FRAMES // 2
    run(stream, kind, frames=rb_app.head(stream["frames"], half),
        ckpt_dir=d, ckpt_every=half)
    assert checkpoint.latest_step(d) == half
    state, outs = run(stream, kind, ckpt_dir=d, ckpt_every=half,
                      resume=True)
    want_state, want_outs = unbroken[kind]
    assert outs["pose"].shape[0] == N_FRAMES
    assert_same(outs, want_outs, "outs")
    assert_same(host(state), host(want_state), "state")
    assert sorted(os.listdir(d)) == [
        "ckpt_12.pt", "ckpt_6.pt", "outs_000000_000006.npz",
        "outs_000006_000012.npz"]


def test_resume_at_rotation_and_missing_chunks(stream, unbroken, tmp_path):
    """Snapshots every 3 frames: ``keep=2`` leaves the newest two, keep=0
    all four; ``resume_at`` an older one gives the unbroken result; a
    missing output chunk raises FileNotFoundError, as does a missing
    snapshot."""
    kind = "fastslam"
    d2, d0 = str(tmp_path / "keep2"), str(tmp_path / "keep0")
    run(stream, kind, ckpt_dir=d2, ckpt_every=3, ckpt_keep=2)
    assert sorted(n for n in os.listdir(d2) if n.startswith("ckpt")) == [
        "ckpt_12.pt", "ckpt_9.pt"]
    run(stream, kind, ckpt_dir=d0, ckpt_every=3, ckpt_keep=0)
    names = os.listdir(d0)
    assert sorted(n for n in names if n.startswith("ckpt")) == [
        "ckpt_12.pt", "ckpt_3.pt", "ckpt_6.pt", "ckpt_9.pt"]
    assert not [n for n in names if n.endswith(".tmp")]
    state, outs = run(stream, kind, ckpt_dir=d0, ckpt_every=3, resume_at=6)
    assert_same(outs, unbroken[kind][1], "outs")
    assert_same(host(state), host(unbroken[kind][0]), "state")

    os.unlink(os.path.join(d0, "outs_000003_000006.npz"))
    with pytest.raises(FileNotFoundError, match="cover frames"):
        run(stream, kind, ckpt_dir=d0, ckpt_every=3, resume_at=9)
    with pytest.raises(FileNotFoundError):
        run(stream, kind, ckpt_dir=d0, ckpt_every=3, resume_at=5)


def test_reseed_changes_the_draws_not_the_restored_state(stream, unbroken,
                                                         tmp_path):
    """``reseed`` resumes from the restored state (the state the frame step
    first sees is the snapshot's, bit for bit) with other draws: the frames
    after the resume differ from the unbroken run's, those before do not;
    the same ``reseed`` gives the same run, another one another."""
    kind = "rbphd"
    filt, icov, _ = stream["built"][kind]
    d = str(tmp_path / "ckpt")
    run(stream, kind, ckpt_dir=d, ckpt_every=6, ckpt_keep=0)
    _, snap = checkpoint.restore(
        d, filt.init_state(torch.zeros(3), dz=3, d=3), step=6)
    seen = []
    step_frame = rb_app.step_frame

    def spy(filt_, state, *a, **k):
        if not seen:
            seen.append(host(state))
        return step_frame(filt_, state, *a, **k)

    rb_app.step_frame = spy
    try:
        _, a = run(stream, kind, ckpt_dir=d, ckpt_every=6, resume_at=6,
                   reseed=7)
    finally:
        rb_app.step_frame = step_frame
    assert_same(seen[0], host(snap), "restored state")
    _, b = run(stream, kind, ckpt_dir=d, ckpt_every=6, resume_at=6,
               reseed=7)
    _, c = run(stream, kind, ckpt_dir=d, ckpt_every=6, resume_at=6,
               reseed=8)
    want = unbroken[kind][1]
    assert_same(a, b, "same reseed")
    np.testing.assert_array_equal(a["pose"][:6], want["pose"][:6])
    assert not np.array_equal(a["pose"][6:], want["pose"][6:])
    assert not np.array_equal(a["pose"][6:], c["pose"][6:])


def test_restore_checks_the_template_and_the_generator(stream, tmp_path):
    """restore rejects a template of another shape or dtype and raises
    FileNotFoundError without a snapshot; it puts the saved generator state
    back, so the next draws repeat."""
    filt = stream["built"]["fastslam"][0]
    state = filt.init_state(torch.zeros(3), d=3)
    d = str(tmp_path / "ckpt")
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(d, state)
    gen = torch.Generator().manual_seed(11)
    checkpoint.save(d, 5, state, gen=gen)
    want = torch.rand(4, generator=gen)
    step, got = checkpoint.restore(d, state, gen=gen)
    assert step == 5
    np.testing.assert_array_equal(torch.rand(4, generator=gen).numpy(),
                                  want.numpy())
    assert_same(host(got), host(state))
    wider = fs_app.build(XmlConfig(stream["cfg"]), map_capacity=48,
                         n_particles=4, device=CPU)[0]
    with pytest.raises(ValueError, match="gm.mean"):
        checkpoint.restore(d, wider.init_state(torch.zeros(3), d=3))
    int64 = dataclasses.replace(state, n_in_fov=state.n_in_fov.long())
    with pytest.raises(ValueError, match="n_in_fov"):
        checkpoint.restore(d, int64)


def test_main_resumes_a_cut_run_to_the_same_logs(stream, tmp_path):
    """The FastSLAM app's command line: a run with snapshots every 4 frames
    is cut after frame 8 (its later snapshot and output chunk removed, as
    a run killed before writing them), then ``--resume`` finishes it; its
    three logs equal the unbroken run's byte for byte."""
    base = ["--cfg", stream["cfg"], "--data", str(stream["dir"]),
            "--particles", "4", "--map-capacity", "32", "--device", "cpu"]
    ck = str(tmp_path / "ckpt")
    fs_app.main(base + ["--logdir", str(tmp_path / "a")])
    fs_app.main(base + ["--logdir", str(tmp_path / "b"), "--ckpt-dir", ck,
                        "--ckpt-every", "4"])
    os.unlink(os.path.join(ck, "ckpt_12.pt"))
    os.unlink(os.path.join(ck, "outs_000008_000012.npz"))
    assert checkpoint.latest_step(ck) == 8
    fs_app.main(base + ["--logdir", str(tmp_path / "c"), "--ckpt-dir", ck,
                        "--ckpt-every", "4", "--resume"])
    for name in ("particlePose.dat", "landmarkEst.dat", "trajectory.dat"):
        assert filecmp.cmp(tmp_path / "a" / name, tmp_path / "c" / name,
                           shallow=False), name


def test_chunks_without_a_directory_keep_nothing(stream):
    """Without a checkpoint directory the loop runs in chunks (or one)
    and writes nothing; chunks do not change the result."""
    kind = "rbphd"
    _, a = run(stream, kind, ckpt_every=5)
    _, b = run(stream, kind)
    assert_same(a, b)
    assert _vp_common.chunked_scan(lambda s, j: (s, {}), None,
                                   torch.Generator(), 0)[:2] == (None, {})
