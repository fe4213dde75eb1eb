"""The port's particle-axis sharding (``rfs_slam_tpu_torch/parallel/mesh.py``
and the dry run ``parallel/dryrun.py``) on the CPU over gloo, held to the JAX package's ``parallel/mesh.py`` and to
the unsharded port.

The ranks are processes of ``tests/torch_dist_worker.py`` (2 and 4 of them,
both groups at once), each with its own time limit, meeting through a
``file://`` rendezvous in a temporary directory; they run every scenario in
one spawn.  Tolerances are ``tests/test_sharding.py``'s: one step pose 1e-5,
``log_w`` 1e-4, ``w`` 1e-4 / 1e-5; 60 steps pose 1e-4, ``log_w`` 1e-3,
``w`` 1e-4 absolute; ``alive`` and ``parent`` exact.  On the CPU a sharded
run is not bit-equal to the unsharded one: a vectorised elementwise kernel
computes a tensor's tail elements with scalar code, so a particle's value
can differ in the last bit with the block's length.
"""

import copy
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from __graft_entry__ import _build, _example_inputs
from rfs_slam_tpu.filters.fastslam import (FastSLAMConfig as JFastSLAMConfig,
                                           FastSLAMFilter as JFastSLAMFilter)
from rfs_slam_tpu.parallel import mesh as jmesh
from rfs_slam_tpu_torch import convert
from rfs_slam_tpu_torch.apps import sim2d_common as loop
from rfs_slam_tpu_torch.filters.rbphd import RBPHDState
from rfs_slam_tpu_torch.io import sim2d_xml, vp_synth
from rfs_slam_tpu_torch.parallel import dryrun, mesh
from tests import torch_dist_worker as worker
from tests.torch_parity import CPU, step_draws, t

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)
MULTISTEPS = 60
P = 8


def graft_filter():
    """The JAX filter of ``__graft_entry__._build`` at test_sharding.py's
    sizes (P=8, M=16, Zc=4)."""
    return _build(n_particles=P, map_capacity=16, z_capacity=4,
                  new_capacity=8, eval_capacity=4, z_dp_max=4)


def jax_fastslam(jfilt):
    """A JAX FastSLAM 1.0 filter with the graft filter's models at P=8,
    M=16, Zc=4."""
    return JFastSLAMFilter(jfilt.motion, jfilt.lmk, jfilt.meas, jfilt.gates,
                           JFastSLAMConfig(n_particles=P, map_capacity=16,
                                           z_capacity=4, nmz_capacity=8,
                                           candidate_capacity=4))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The scenarios written for the workers, the sharded results of 2 and
    4 ranks, and the unsharded runs of the multi-step scenarios."""
    d = tmp_path_factory.mktemp("mesh")
    jfilt = graft_filter()
    filt = convert.filter_from_numpy(jfilt, CPU)
    jstate, odo, z, zm = _example_inputs(jfilt, jax.random.PRNGKey(0))
    noise, u0 = step_draws(jstate.particles.key, P)
    rng = np.random.default_rng(7)
    n = MULTISTEPS
    z, zm = np.asarray(z, np.float32), np.asarray(zm)
    multistep = (np.asarray(odo, np.float32)
                 + 0.05 * rng.standard_normal((n, 3)).astype(np.float32),
                 np.tile(z[None], (n, 1, 1)), np.tile(zm[None], (n, 1)),
                 np.zeros((n, 3), np.float32), np.zeros(n, bool))
    vp_dir = str(d / "vp")
    vp_synth.write(vp_dir, seed=0, n_frames=6)
    spec = {
        "one_step": dict(filt=filt, state=convert.from_numpy(
            RBPHDState, jstate, CPU), odo=t(odo, torch.float32),
            z=t(z), z_mask=t(zm), noise=t(noise), u0=t(u0)),
        "multistep": dict(filt=filt, inputs=multistep),
        "fastslam": dict(sim=dict(timesteps=13, n_landmarks=20,
                                  n_segments=2),
                         xml=sim2d_xml.write_config(str(d / "fs.xml")),
                         zc=12, particles=P),
        "vp": dict(cfg=vp_synth.write_config(os.path.join(vp_dir,
                                                          "config.xml")),
                   dir=vp_dir, map_capacity=64, particles=P),
    }
    torch.save(spec, d / "inputs.pt")
    sharded = worker.finish(d, worker.start(d, WORLDS))
    plain = {name: dryrun.drive_logged(f, drive, steps, CPU)
             for name, (f, drive, steps) in worker.drives(spec).items()}
    return jfilt, jstate, spec, sharded, plain


def spec_axes(tree, name=""):
    """``{field path: particle axis or None}`` of JAX shardings or the
    port's placements (JAX's particle key left out)."""
    out = {}
    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        path = f"{name}.{f.name}" if name else f.name
        if f.name == "key":
            continue
        if hasattr(v, "spec"):
            s = tuple(v.spec)
            out[path] = s.index(jmesh.PARTICLE_AXIS) if (
                jmesh.PARTICLE_AXIS in s) else None
        elif isinstance(v, tuple):
            out[path] = getattr(v[0], "dim", None)
        else:
            out.update(spec_axes(v, path))
    return out


@pytest.mark.parametrize("kind", ["rbphd", "fastslam"])
def test_state_shardings_match_jax(kind):
    """Field for field, the port's placements split what JAX's
    ``state_shardings`` splits, on the same axis."""
    jfilt = graft_filter()
    if kind == "fastslam":
        jfilt = jax_fastslam(jfilt)
    jstate = (_example_inputs(jfilt, jax.random.PRNGKey(0))[0]
              if kind == "rbphd" else
              jfilt.init_state(jax.random.PRNGKey(0), jnp.zeros(3)))
    jmesh_ = jmesh.make_mesh(4, devices=jax.devices("cpu")[:4])
    want = spec_axes(jmesh.state_shardings(jstate, jmesh_, P))
    port = convert.filter_from_numpy(jfilt, CPU).init_state(torch.zeros(3))
    got = spec_axes(mesh.state_shardings(port))
    assert got == want
    assert got["gm.mean"] == 1 and got["particles.pose"] == 0


def test_state_shardings_keep_last_z_whole_when_zc_equals_p():
    """Zc == P: JAX's shape rule splits ``last_z [Zc, DZ]`` (a layout
    choice under GSPMD); the port, which would hand each rank other
    measurements, keeps it whole by the field's declaration."""
    jfilt = _build(n_particles=P, map_capacity=16, z_capacity=P,
                   new_capacity=8, eval_capacity=4, z_dp_max=4)
    jstate = _example_inputs(jfilt, jax.random.PRNGKey(0))[0]
    jmesh_ = jmesh.make_mesh(4, devices=jax.devices("cpu")[:4])
    assert spec_axes(jmesh.state_shardings(jstate, jmesh_, P))["last_z"] == 0
    port = convert.filter_from_numpy(jfilt, CPU).init_state(torch.zeros(3))
    sh = mesh.state_shardings(port)
    assert sh.last_z == mesh.replicated(None)
    assert sh.last_unused == mesh.particle_sharding(None)
    one = mesh.make_mesh(P, CPU)
    assert torch.equal(mesh.shard_state(port, one).last_z, port.last_z)


def assert_step_close(got, want):
    """test_sharding.py's one-step tolerances."""
    np.testing.assert_allclose(got.particles.pose.numpy(),
                               np.asarray(want.particles.pose), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.particles.log_w.numpy(),
                               np.asarray(want.particles.log_w), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(got.gm.alive.numpy(),
                                  np.asarray(want.gm.alive))
    np.testing.assert_allclose(got.gm.w.numpy(), np.asarray(want.gm.w),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got.particles.parent.numpy(),
                                  np.asarray(want.particles.parent))


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_step_matches_jax_sharded_step(runs, world):
    """The port's step on 2 and 4 gloo ranks, given JAX's draws, against
    JAX's step sharded over the 4-device virtual CPU mesh."""
    jfilt, jstate, spec, sharded, _ = runs
    s = spec["one_step"]
    devs = jax.devices("cpu")[:4]
    jm = jmesh.make_mesh(4, devices=devs)
    shardings = jmesh.state_shardings(jstate, jm, P)
    repl = jmesh.replicated(jm)

    def step(st, o, zz, zzm):
        st = jfilt.predict(st, o, worker.DT)
        return jfilt.update(st, zz, zzm)

    with jax.default_device(devs[0]):
        want = jax.jit(step, in_shardings=(shardings, repl, repl, repl),
                       out_shardings=shardings)(
            jax.tree_util.tree_map(jax.device_put, jstate, shardings),
            *jax.device_put((s["odo"].numpy(), s["z"].numpy(),
                             s["z_mask"].numpy()), repl))
    assert_step_close(sharded[world]["one_step"], want)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_60_steps_match_one_rank(runs, world):
    """60 steps of the graft filter through ``sim2d_common.steps`` on 2 and
    4 ranks against the unsharded run from the same generator seed: at
    least 3 resamples, at least one ancestor taken from another rank;
    ``parent``, ``did`` and ``alive`` exact, floats within the multistep
    tolerances."""
    _, _, _, sharded, plain = runs
    sh, pl = sharded[world]["multistep"], plain["multistep"]
    assert int(pl["did"].sum()) >= 3
    p_local = P // world
    moved = (sh["parent"] // p_local) != (np.arange(P) // p_local)[None, :]
    assert moved[sh["did"]].any()
    rec = dryrun.compare(sh, pl)
    assert rec["ok"], rec
    # two collectives an update: the weights and the ancestor gather
    assert sh["collectives"]["collectives"] == 2 * MULTISTEPS


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_run_best_pose_from_global_weights(runs, world):
    """``sim2d_common.run`` under a mesh: each step's best particle is the
    argmax of the global weights, as in the unsharded run."""
    _, _, spec, sharded, _ = runs
    m = spec["multistep"]
    _, want = loop.run(m["filt"], m["inputs"],
                       torch.Generator().manual_seed(0), worker.DT)
    np.testing.assert_allclose(sharded[world]["best"], want, rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["fastslam", "vp"])
def test_other_paths_sharded_match_unsharded(runs, world, name):
    """FastSLAM 1.0 on a short simulation and Victoria Park RB-PHD (D=3) on
    a short synthetic stream, sharded against unsharded."""
    _, _, _, sharded, plain = runs
    rec = dryrun.compare(sharded[world][name], plain[name])
    assert rec["ok"], rec
    assert int(plain[name]["did"].sum()) >= 1


@pytest.mark.parametrize("field", ["gm.mean", "gm.cov", "birth.cov",
                                   "birth.n_support", "last_unused",
                                   "n_in_fov"])
def test_compare_holds_every_field_of_the_final_state(runs, field):
    """``dryrun.compare`` fails a run whose final state differs from the
    unsharded one in any field, not only in pose, ``log_w``, ``w`` and
    ``alive``: a float field by 2e-4 (relative above 1), an integer or
    bool field in one entry."""
    plain = runs[4]["vp"]
    bad = copy.deepcopy(plain)
    *parents, leaf = field.split(".")
    node = bad["final"]
    for k in parents:
        node = node[k]
    a = node[leaf]
    if a.dtype.kind == "f":
        i = np.flatnonzero(np.isfinite(a))[0]
        a.flat[i] += np.float32(2e-4 * max(1.0, abs(float(a.flat[i]))))
    else:
        a.flat[0] = not a.flat[0] if a.dtype == bool else a.flat[0] + 1
    assert dryrun.compare(plain, plain)["ok"]
    rec = dryrun.compare(bad, plain)
    assert not rec["ok"]
    assert (rec["max_rel_other_field"] == field if a.dtype.kind == "f"
            else rec["exact_fields_differing"] == [field])


@pytest.mark.parametrize("world", WORLDS)
def test_global_ess_and_mass(runs, world):
    """For w proportional to i, the global ESS is (sum i)^2 / sum i^2 and
    the normalised mass is 1 (dist_smoke_worker.py's checks)."""
    got = runs[3][world]["smoke"]
    expect = (P * (P + 1) / 2) ** 2 / sum(i * i for i in range(1, P + 1))
    assert abs(got["ess"] - expect) < 1e-3
    assert abs(got["mass"] - 1.0) < 1e-5


def test_one_rank_mesh_is_the_unsharded_step():
    """A mesh of one rank without a process group runs the packed gather
    and the block draws: the same step, bit for bit, as ``mesh=None``."""
    filt = convert.filter_from_numpy(graft_filter(), CPU)
    one = mesh.make_mesh(P, CPU)
    assert (one.world, one.p_local, one.group) == (1, P, None)
    rng = np.random.default_rng(3)
    inputs = (rng.normal(0.03, 0.05, (12, 3)).astype(np.float32),
              np.tile(np.asarray([[1.5, -0.3], [1.5, 0.3], [1.4, 0.0],
                                  [0.0, 0.0]], np.float32), (12, 1, 1)),
              np.tile(np.asarray([1, 1, 1, 0], bool), (12, 1)),
              np.zeros((12, 3), np.float32), np.zeros(12, bool))
    din = loop.device_inputs(inputs, CPU)
    outs = [loop.steps(filt, din, torch.Generator().manual_seed(0), 0.1,
                       lambda k, s: None, m) for m in (None, one)]
    for a, b in zip(*(jax.tree_util.tree_leaves(convert.to_numpy(o))
                      for o in outs)):
        np.testing.assert_array_equal(a, b)
    assert one.stats["collectives"] == 2 * 12


@pytest.mark.parametrize("world", WORLDS)
def test_make_mesh_refuses_an_uneven_split(runs, world):
    """P + 1 particles over 2 or 4 ranks: refused, as JAX refuses a
    NamedSharding of an indivisible axis."""
    assert runs[3][world]["uneven_refused"]


def test_entry_point_needs_gpus_unless_cpu_is_asked():
    """No fallback hides the device: without GPUs the dry run raises
    unless ``--device cpu`` is given."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        dryrun.main(["--ranks", "2", "--path", "replay", "--steps", "1"])


def test_entry_point_on_cpu_ranks():
    """``python -m rfs_slam_tpu_torch.parallel.dryrun --device cpu``: FastSLAM
    1.0 at full width (P=200), 2 gloo ranks, 2 steps, held to the
    unsharded run; one JSON line with the record."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-m", "rfs_slam_tpu_torch.parallel.dryrun",
         "--ranks", "2", "--device", "cpu", "--path", "fastslam",
         "--steps", "2", "--timeout", "200"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["ok"] and rec["backend"] == "gloo" and rec["p_local"] == 100
    assert rec["collectives_per_step"] == 2
