"""The port's phase spans and tallies (``utils/timing.py``: ``span``,
``tally``, ``tallies``) on the CPU: the spans a 2-D RB-PHD step, Victoria
Park frames and FastSLAM steps record under ``torch.profiler``, nested as
the filters document them; nothing recorded or kept with no profiler
running, and the same outputs to the bit; the tallies against the counts
recomputed from the step's inputs and outputs; and every span a per-layer
metric of the benchmark declares is one the port emits on its cell's
path."""

import collections
import dataclasses
import importlib.util
import os
import tempfile
import weakref

import numpy as np
import pytest
import torch

from portbench import spec
from rfs_slam_tpu_torch.apps import _vp_common
from rfs_slam_tpu_torch.apps import fastslam2dsim as fs_app
from rfs_slam_tpu_torch.apps import rbphdslam2dsim as app2d
from rfs_slam_tpu_torch.apps import rbphdslam_victoriapark as vp_app
from rfs_slam_tpu_torch.apps import sim2d_common as loop
from rfs_slam_tpu_torch.io import sim2d, sim2d_xml
from rfs_slam_tpu_torch.io import victoria_park as vp_io
from rfs_slam_tpu_torch.io import vp_synth
from rfs_slam_tpu_torch.io.xmlconfig import XmlConfig
from rfs_slam_tpu_torch.ops import gm as gm_ops
from rfs_slam_tpu_torch.utils import timing

CPU = torch.device("cpu")
PREFIXES = ("rbphd.", "fastslam.", "vp.")
UPDATE_2D = ("rbphd.map_update", "rbphd.importance", "rbphd.merge",
             "rbphd.prune", "rbphd.resample")
WARM_STEPS = 10   # past the ground-truth lock's first steps, maps populated


def profiled(fn):
    """``(fn(), [(span, enclosing span or None)])`` with ``fn`` run under a
    CPU profiler, the nesting from the spans' intervals (the profiler's
    own event tree takes minutes over a Murty step's ops)."""
    timing.tallies()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    ivs = sorted((e.start_ns(), -(e.start_ns() + e.duration_ns()), e.name())
                 for e in prof.profiler.kineto_results.events()
                 if e.name().startswith(PREFIXES))
    found, open_ = [], []
    for a, neg_b, name in ivs:
        while open_ and open_[-1][0] < -neg_b:
            open_.pop()
        found.append((name, open_[-1][1] if open_ else None))
        open_.append((-neg_b, name))
    return out, found


def leaves(x, prefix=""):
    """``{path: tensor}`` of a state's tensors."""
    if isinstance(x, torch.Tensor):
        return {prefix: x}
    out = {}
    for f in dataclasses.fields(x):
        out.update(leaves(getattr(x, f.name), f"{prefix}.{f.name}"))
    return out


def mid_run(filt, cfg, data, want=lambda state: True):
    """The state after the first step past WARM_STEPS that meets ``want``
    and is followed by a step with measurements, and that step's inputs."""
    din = loop.device_inputs(loop.sim_inputs(data), CPU)
    kept = []

    def keep(k, state):
        if not kept and k >= WARM_STEPS and din[-1][k + 1] and want(state):
            kept.append((k + 1, state))

    loop.steps(filt, din, torch.Generator().manual_seed(0), cfg.dt, keep)
    k, state = kept[0]
    return state, (din[0][k], din[1][k], din[2][k])


@pytest.fixture(scope="module")
def sim():
    """The 2-D bench filter at 8 particles, a state of a short simulation
    with unused measurements from its last update (so the next predict has
    births) and the inputs of the next step, which has measurements."""
    cfg = sim2d.Sim2DConfig(timesteps=40, n_landmarks=12, n_segments=3)
    data = sim2d.generate(cfg, traj_seed=1, noise_seed=1, z_capacity=40)
    filt = app2d.build_filter(cfg, CPU, n_particles=8)
    state, inputs = mid_run(filt, cfg, data,
                            lambda s: bool(s.last_unused.any()))
    return filt, state, inputs, cfg.dt


def sim_step(sim, seed=1):
    filt, state, (odo, z, zm), dt = sim
    gen = torch.Generator().manual_seed(seed)
    pred = filt.predict(state, odo, dt, gen=gen)
    return pred, filt.update(pred, z, zm, gen=gen, has_z=True)


@pytest.fixture(scope="module")
def vp():
    """The Victoria Park filter at 4 particles and 32 slots on 3 synthetic
    frames with scans."""
    with tempfile.TemporaryDirectory() as d:
        vp_synth.write(d, seed=0, n_frames=3, scans=True)
        filt, icov, ack = vp_app.build(
            XmlConfig(vp_synth.write_config(d + "/config.xml")),
            map_capacity=32, n_particles=4, device=CPU)
        frames = vp_io.load(d, z_capacity=24, ackerman=ack)
    return filt, icov, frames


def vp_run(vp, chunk):
    filt, icov, frames = vp
    gen = torch.Generator().manual_seed(0)
    step = _vp_common.make_frame_step(filt, vp_app.step_frame, frames, gen,
                                      icov)

    def frame_step(state, j):
        state = step(state, j)
        return state, {"pose": state.particles.pose}

    state = filt.init_state(torch.zeros(3), dz=3, d=3)
    return _vp_common.chunked_scan(frame_step, state, gen, len(frames.t),
                                   ckpt_every=chunk, progress=False)[0]


@pytest.fixture(scope="module", params=[1, 3], ids=["fastslam", "mh"])
def fs(request):
    """FastSLAM 1.0 (or MH-FastSLAM, 3 hypotheses) at 2 particles on the
    stand-in XML, a state past WARM_STEPS steps and the next step's inputs
    with measurements."""
    kind = "fastslam" if request.param == 1 else "mhfastslam"
    cfg = sim2d.Sim2DConfig(timesteps=WARM_STEPS + 4, n_landmarks=12,
                            n_segments=3)
    data = sim2d.generate(cfg, traj_seed=1, noise_seed=1, z_capacity=40)
    with tempfile.TemporaryDirectory() as d:
        xcfg = XmlConfig(sim2d_xml.write_config(d + "/fs.xml", kind))
    filt = fs_app.build_filter_from_xml(xcfg, cfg, z_capacity=40,
                                        n_particles=2, device=CPU)
    state, inputs = mid_run(filt, cfg, data)
    return request.param, filt, state, inputs, cfg.dt


def test_rbphd2d_step_records_its_phases_nested(sim):
    _, found = profiled(lambda: sim_step(sim))
    want = collections.Counter({("rbphd.predict", None): 1,
                                ("rbphd.births", "rbphd.predict"): 1,
                                ("rbphd.update", None): 1})
    want.update({(name, "rbphd.update"): 1 for name in UPDATE_2D})
    assert collections.Counter(found) == want


def test_vp_frames_record_births_substeps_update_and_readback(vp):
    """Each frame: births once, on their own, a predict a substep, the
    update with its phases where the frame has measurements; a read-back a
    chunk."""
    filt, _, frames = vp
    dts = np.where(frames.pred_valid, frames.pred_dt, 0).astype(np.float32)
    subs = int((dts != 0).sum())
    _, z_mask = _vp_common.add_clutter(filt, frames, 0.0)
    with_z = int(z_mask.any(axis=1).sum())
    assert (dts != 0).sum(axis=1).min() >= 2 and with_z >= 1
    _, found = profiled(lambda: vp_run(vp, chunk=2))
    want = collections.Counter({("rbphd.births", None): 3,
                                ("rbphd.predict", None): subs,
                                ("rbphd.update", None): 3,
                                ("vp.readback", None): 2})
    want.update({(name, "rbphd.update"): with_z for name in UPDATE_2D})
    assert collections.Counter(found) == want


def test_fastslam_step_records_its_phases_nested(fs):
    H, filt, state, (odo, z, zm), dt = fs

    def step():
        gen = torch.Generator().manual_seed(1)
        s = filt.predict(state, odo, dt, gen=gen)
        return filt.update(s, z, zm, gen=gen, has_z=True)

    _, found = profiled(step)
    inside = {"fastslam.da_table": 1, "fastslam.assoc": 1,
              "fastslam.map_update": H if H > 1 and not filt.cfg.mh_grow
              else 1,
              "fastslam.prune": 1, "fastslam.births": 1,
              # grow mode: the ancestors' draw and the selected hypotheses'
              # gather
              "fastslam.resample": 2 if H > 1 else 1}
    want = collections.Counter({("fastslam.predict", None): 1,
                                ("fastslam.update", None): 1})
    want.update({(n, "fastslam.update"): c for n, c in inside.items()})
    assert collections.Counter(found) == want


def test_no_profiler_records_nothing_and_keeps_the_outputs(sim, vp,
                                                           monkeypatch):
    """With no profiler running no span opens a range and no tally keeps
    a tensor, and the step's outputs are a profiled run's to the bit."""
    on_pred, on_out = profiled(lambda: sim_step(sim))[0]
    on_vp = profiled(lambda: vp_run(vp, chunk=2))[0]
    timing.tallies()
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name))
    off_pred, off_out = sim_step(sim)
    off_vp = vp_run(vp, chunk=2)
    assert opened == [] and timing.tallies() == {}
    for on, off in ((on_pred, off_pred), (on_out, off_out), (on_vp, off_vp)):
        a, b = leaves(on), leaves(off)
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_tallies_equal_the_counts_recomputed_from_the_step(sim):
    filt, state, (odo, z, zm), dt = sim
    cfg = filt.cfg
    assert cfg.birth_count_threshold == 1
    (pred, out), _ = profiled(lambda: sim_step(sim))
    got = timing.tallies()
    assert timing.tallies() == {}          # read once, then reset
    gm_full = filt._map_update(pred, z, zm)[0]
    merged = gm_ops.merge(gm_full, cfg.merge_threshold, cfg.merge_inflation)
    want = {"rbphd.born": float(state.last_unused.sum()),
            "rbphd.merge_in": float(gm_full.alive.sum()),
            "rbphd.merge_out": float(merged.alive.sum()),
            "rbphd.resampled": float(out.n_updates == 0)}
    assert got == want
    assert want["rbphd.born"] > 0 and want["rbphd.merge_in"] > 0


def test_tally_and_span_keep_nothing_with_the_profiler_off():
    timing.tallies()
    timing.tally("x", torch.ones(3))

    @timing.span("rbphd.unit")
    def f(a):
        return a + 1

    with timing.span("rbphd.block") as s:
        assert f(1) == 2
    assert s._range is None and timing.tallies() == {}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        timing.tally("x", torch.tensor([True, False, True]))
        timing.tally("x", torch.tensor(2))
        with timing.span("rbphd.block"):
            f(1)
    assert timing.tallies() == {"x": 4.0}
    names = [e.name for e in prof.events()]
    assert names.count("rbphd.block") == 1 and names.count("rbphd.unit") == 1


def test_profile_window_reads_back_each_chunk(vp):
    """``scripts/profile_torch.py``'s Victoria Park window runs the app's
    chunked loop: one ``vp.readback`` span a chunk, outside the filter's
    spans, and the same state as the window stepped frame by frame."""
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "scripts", "profile_torch.py")
    mod_spec = importlib.util.spec_from_file_location("profile_torch", path)
    prof = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(prof)
    filt, icov, frames = vp

    def run(window_of):
        gen = torch.Generator().manual_seed(0)
        step = _vp_common.make_frame_step(filt, vp_app.step_frame, frames,
                                          gen, icov)
        state = step(filt.init_state(torch.zeros(3), dz=3, d=3), 0)
        return window_of(step, gen)(state, 1, 2)

    chunked, found = profiled(lambda: run(
        lambda step, gen: prof.chunked(
            step, lambda s: _vp_common.frame_outputs(
                s, torch.exp(s.particles.log_w)), gen, 1)))
    assert collections.Counter(found)[("vp.readback", None)] == 2
    assert "vp.readback" in prof.SPANS
    plain = run(lambda step, gen: prof.stepwise(step))
    a, b = leaves(chunked), leaves(plain)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_tallies_live_for_one_profiler_session(sim):
    """A session's unread tallies stay readable after it ends, through
    untraced steps, and go when a later session tallies: two profiled
    steps with an untraced one between them read as one step's counts."""
    cpu = [torch.profiler.ProfilerActivity.CPU]
    timing.tallies()
    first = torch.tensor([True, True, False])
    kept = weakref.ref(first)
    with torch.profiler.profile(activities=cpu):
        timing.tally("x", first)
    del first
    timing.tally("x", torch.ones(2))       # untraced: kept nothing
    assert kept() is not None
    assert timing.tallies(reset=False) == {"x": 2.0}
    with torch.profiler.profile(activities=cpu):
        timing.tally("x", torch.tensor(5))
    assert kept() is None
    assert timing.tallies() == {"x": 5.0}

    profiled(lambda: sim_step(sim))
    one = timing.tallies()
    for _ in range(2):
        with torch.profiler.profile(activities=cpu):
            sim_step(sim)
        sim_step(sim)
    assert timing.tallies() == one and one["rbphd.merge_in"] > 0


def test_every_declared_range_is_a_span_the_port_emits(sim, vp):
    """Each per-layer metric's ``RANGES`` names a span that the port
    emits itself on the path of every cell that reports the metric, so no
    reader depends on a wrap from outside."""
    paths = {"rbphd2d": {n for n, _ in profiled(lambda: sim_step(sim))[1]},
             "vp_rbphd": {n for n, _ in profiled(
                 lambda: vp_run(vp, chunk=2))[1]}}
    bench = spec.benchmark()
    checked = 0
    for w in bench["workloads"]:
        c = spec.cell(w["name"])
        names = paths[c["config"]["driver"]]
        for m in c["per_layer"]:
            for r in getattr(spec.metric(m), "RANGES", {}):
                assert r in names, (w["name"], m, r)
                checked += 1
    assert checked >= 12
