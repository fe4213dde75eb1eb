"""The port's particles x map mesh (``parallel/mesh.py``: ``make_mesh_2d``,
``state_shardings_2d``, ``MapMesh``; ``filters/rbphd.py`` and the block
form of ``ops/kernels/map_update2d.py``) on the CPU over gloo, held to the
JAX package's map-sharded step and to the unsharded port.

The ranks are processes of ``tests/torch_dist_worker.py`` (suite ``map``):
a 1 x 2 mesh on 2 ranks and a 2 x 2 mesh on 4, both groups at once,
started before this process's JAX step so that the two overlap.  The
graft filter of ``tests/test_sharding.py`` (P=8, M=16, Zc=4) with its
tolerances: pose 1e-5, ``log_w`` 1e-4, ``w`` 1e-4 relative and 1e-5
absolute, means 1e-4, ``alive`` exact.
"""

import dataclasses

import numpy as np
import jax
import pytest
import torch

from __graft_entry__ import _build, _example_inputs
from rfs_slam_tpu.parallel import mesh as jmesh
from rfs_slam_tpu_torch import convert
from rfs_slam_tpu_torch.apps import sim2d_common as loop
from rfs_slam_tpu_torch.filters.rbphd import RBPHDState
from rfs_slam_tpu_torch.parallel import dryrun, mesh
from tests import torch_dist_worker as worker
from tests.test_torch_mesh import graft_filter, jax_fastslam
from tests.torch_parity import CPU, step_draws, t

WORLDS = (2, 4)
P, M = 8, 16
TEACHER_WARM, TEACHER_STEPS = 4, 20


def multistep_inputs(n):
    """``n`` steps of the graft scenario (test_sharding.py's multistep
    run): noisy odometry, the example measurements every step."""
    jfilt = graft_filter()
    _, odo, z, zm = _example_inputs(jfilt, jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    z, zm = np.asarray(z, np.float32), np.asarray(zm)
    return (np.asarray(odo, np.float32)
            + 0.05 * rng.standard_normal((n, 3)).astype(np.float32),
            np.tile(z[None], (n, 1, 1)), np.tile(zm[None], (n, 1)),
            np.zeros((n, 3), np.float32), np.zeros(n, bool))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's step on the 2 x 4 virtual mesh, the port's unsharded step,
    and the workers' results on 1 x 2 and 2 x 2 meshes."""
    d = tmp_path_factory.mktemp("map_mesh")
    jfilt = graft_filter()
    filt = convert.filter_from_numpy(jfilt, CPU)
    jstate, odo, z, zm = _example_inputs(jfilt, jax.random.PRNGKey(0))
    noise, u0 = step_draws(jstate.particles.key, P)
    state = convert.from_numpy(RBPHDState, jstate, CPU)
    one = dict(filt=filt, state=state, odo=t(odo, torch.float32), z=t(z),
               z_mask=t(zm), noise=t(noise), u0=t(u0))
    spec = {"one_step": one,
            "teacher": dict(filt=filt, state=state, warm=TEACHER_WARM,
                            steps=TEACHER_STEPS, inputs=multistep_inputs(
                                TEACHER_WARM + TEACHER_STEPS))}
    torch.save(spec, d / "inputs.pt")
    procs = worker.start(d, WORLDS, "map")
    try:
        devs = jax.devices("cpu")[:8]
        jm = jmesh.make_mesh_2d(2, 4, devices=devs)
        shardings = jmesh.state_shardings_2d(jstate, jm, P, M)
        repl = jax.sharding.NamedSharding(jm, jax.sharding.PartitionSpec())

        def step(st, o, zz, zzm):
            st = jfilt.predict(st, o, worker.DT)
            return jfilt.update(st, zz, zzm)

        with jax.default_device(devs[0]):
            want = jax.jit(step, in_shardings=(shardings, repl, repl, repl),
                           out_shardings=shardings)(
                jax.tree_util.tree_map(jax.device_put, jstate, shardings),
                *jax.device_put((np.asarray(odo, np.float32),
                                 np.asarray(z), np.asarray(zm)), repl))
        s = filt.predict(state, one["odo"], worker.DT, noise=one["noise"])
        plain = filt.update(s, one["z"], one["z_mask"], u0=one["u0"])
    except BaseException:
        for _, p in procs:
            p.kill()
        raise
    return jstate, want, plain, worker.finish(d, procs)


def spec_axes_2d(tree, name=""):
    """``{field path: (particle axis, map axis)}`` of JAX's 2-D shardings
    or the port's placements (JAX's particle key left out)."""
    out = {}
    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        path = f"{name}.{f.name}" if name else f.name
        if f.name == "key":
            continue
        if hasattr(v, "spec"):
            s = tuple(v.spec)
            out[path] = tuple(s.index(a) if a in s else None
                              for a in (jmesh.PARTICLE_AXIS, jmesh.MAP_AXIS))
        elif isinstance(v, tuple):
            out[path] = tuple(getattr(p, "dim", None) for p in v)
        else:
            out.update(spec_axes_2d(v, path))
    return out


def test_state_shardings_2d_match_jax():
    """Field for field, the port's placements split what JAX's
    ``state_shardings_2d`` splits on the graft state, on the same axes:
    the map's fields over particles and slots, the other per-particle
    fields over particles, the rest whole.  The two rules part only where
    JAX's shapes are ambiguous: the birth candidates' ``[P, C]`` fields
    with C = P = 8, which JAX's rule (a leading axis of M fails, then "axis
    1 is P") splits on the candidates."""
    jfilt = graft_filter()
    jstate = _example_inputs(jfilt, jax.random.PRNGKey(0))[0]
    jm = jmesh.make_mesh_2d(2, 4, devices=jax.devices("cpu")[:8])
    want = spec_axes_2d(jmesh.state_shardings_2d(jstate, jm, P, M))
    port = convert.filter_from_numpy(jfilt, CPU).init_state(torch.zeros(3))
    got = spec_axes_2d(mesh.state_shardings_2d(port))
    assert got.keys() == want.keys()
    ambiguous = {"birth.n_support", "birth.n_checks", "birth.alive"}
    assert port.birth.capacity == P
    assert {k for k in got if got[k] != want[k]} == ambiguous
    assert all(want[k] == (1, None) and got[k] == (0, None)
               for k in ambiguous)
    assert got["gm.mean"] == (1, 2) and got["gm.alive"] == (0, 1)
    assert got["birth.mean"] == (1, None) and got["last_z"] == (None, None)


def test_state_shardings_2d_keep_zc_whole_when_zc_equals_m():
    """Zc == M: JAX's shape rule splits ``last_unused [P, Zc]`` over the
    map axis; the port, whose measurements are not slots, keeps it whole
    over the map by the field's declaration."""
    jfilt = _build(n_particles=P, map_capacity=M, z_capacity=M,
                   new_capacity=8, eval_capacity=4, z_dp_max=4)
    jstate = _example_inputs(jfilt, jax.random.PRNGKey(0))[0]
    jm = jmesh.make_mesh_2d(2, 4, devices=jax.devices("cpu")[:8])
    assert spec_axes_2d(jmesh.state_shardings_2d(
        jstate, jm, P, M))["last_unused"] == (0, 1)
    port = convert.filter_from_numpy(jfilt, CPU).init_state(torch.zeros(3))
    assert spec_axes_2d(mesh.state_shardings_2d(port))["last_unused"] == (
        0, None)


def assert_step_close(got, want):
    """test_sharding.py's map-axis tolerances, ``parent`` exact."""
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
    np.testing.assert_allclose(got.gm.mean.numpy(), np.asarray(want.gm.mean),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.particles.parent.numpy(),
                                  np.asarray(want.particles.parent))


@pytest.mark.parametrize("world", WORLDS)
def test_map_mesh_step_matches_jax_map_sharded_step(runs, world):
    """The port's step on a 1 x 2 and a 2 x 2 gloo mesh, given JAX's draws,
    against JAX's step on the 2 x 4 particles x map virtual mesh."""
    _, want, _, sharded = runs
    assert sharded[world]["m_local"] == M // 2
    assert_step_close(sharded[world]["one_step"], want)


@pytest.mark.parametrize("world", WORLDS)
def test_map_mesh_step_matches_unsharded(runs, world):
    """The same step against the unsharded port: every integer and bool
    field equal, floats within ``dryrun.compare_states``' tolerances; the
    step's collectives: the map gathered for the births, the column sums,
    the picks, the planes for the new Gaussians, the eval points, the
    intensity sums, the map for the merge, the weights and the rows."""
    _, _, plain, sharded = runs
    rec = dryrun.compare_states(dryrun._host(sharded[world]["one_step"]),
                                dryrun._host(plain))
    assert rec["ok"], rec
    assert sharded[world]["stats"]["collectives"] == 9


def test_teacher_forced_steps_on_2x2(runs):
    """20 steps on the 2 x 2 mesh, each from the unsharded port's state
    with the same draws (after 4 free steps from the graft state): every
    step's integer and bool fields equal and its floats within the
    tolerances; the run resamples; nine collectives a step."""
    tf = runs[3][4]["teacher"]
    assert len(tf["records"]) == TEACHER_STEPS
    bad = [(i, r) for i, r in enumerate(tf["records"]) if not r["ok"]]
    assert not bad, bad
    assert tf["did"].sum() >= 3
    assert tf["collectives"]["collectives"] == 9 * TEACHER_STEPS


@pytest.mark.parametrize("world", WORLDS)
def test_make_mesh_2d_refuses_uneven_splits(runs, world):
    """9 particles over 2 or 4 particle blocks, 17 slots over 2 or 4 map
    blocks, and a 1 x 1 mesh over 2 or 4 ranks: each refused."""
    assert runs[3][world]["refused"] == {"particles": True, "slots": True,
                                         "ranks": True}


@pytest.mark.parametrize("cluster", [False, True])
def test_one_by_one_map_mesh_is_the_unsharded_run(cluster):
    """A 1 x 1 map mesh without a process group runs the block form (two
    map_update2d launches' twins), the gathers and the combines: the same
    run, bit for bit, as ``mesh=None``, with nine collectives a step
    (with the single-cluster weighting: the weight sum's instead of the
    eval points' and intensities')."""
    jfilt = graft_filter()
    jfilt.cfg = dataclasses.replace(jfilt.cfg, use_cluster_process=cluster)
    filt = convert.filter_from_numpy(jfilt, CPU)
    one = mesh.make_mesh_2d(1, 1, P, M, CPU)
    din = loop.device_inputs(multistep_inputs(10), CPU)
    outs = [loop.steps(filt, din, torch.Generator().manual_seed(0), 0.1,
                       lambda k, s: None, m) for m in (None, one)]
    for a, b in zip(*(jax.tree_util.tree_leaves(convert.to_numpy(o))
                      for o in outs)):
        np.testing.assert_array_equal(a, b)
    assert one.stats["collectives"] == (8 if cluster else 9) * 10


def fake_map_mesh(p_global):
    """A 1 x 2 map mesh's description, with no process group behind it."""
    return mesh.MapMesh(1, 0, p_global, CPU, m_global=M, map_world=2)


def test_fastslam_and_vp_under_a_map_mesh_raise():
    """FastSLAM and the Victoria Park RB-PHD path are not ported to the map
    mesh: both raise, naming the ROADMAP row, before any collective."""
    jfilt = graft_filter()
    fs = convert.filter_from_numpy(jax_fastslam(jfilt), CPU)
    state = fs.init_state(torch.zeros(3))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fs.update(state, torch.zeros((4, 2)), torch.ones(4, dtype=bool),
                  u0=torch.zeros(()), mesh=fake_map_mesh(P))
    rb = convert.filter_from_numpy(jfilt, CPU)
    vp_state = rb.init_state(torch.zeros(3), dz=3, d=3)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rb.predict(vp_state, torch.zeros(3), 0.1, noise=torch.zeros(P, 3),
                   mesh=fake_map_mesh(P))
    with pytest.raises(ValueError, match="map mesh"):
        dryrun.main(["--ranks", "2", "--device", "cpu", "--map-shards", "2",
                     "--path", "fastslam"])
