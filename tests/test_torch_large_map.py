"""Maps beyond the small kernels' 1,024 slots, on the CPU: the three launch
plans (the small forms' plans unchanged, the large forms' within Hopper's
limits with their workspaces), the merge twins and the map update's twin
against the JAX package at M=1,056, the port's example step against
``__graft_entry__``'s, and ``map_overflow_demo``'s mesh mode over two gloo
ranks.  The large forms themselves run only on the card (chip_smoke.py,
phase 16)."""

import json
import os
import subprocess
import sys

import numpy as np
import jax
import pytest
import torch

from __graft_entry__ import _build, _example_inputs
from rfs_slam_tpu.ops import gm as jgm
from rfs_slam_tpu_torch import convert
from rfs_slam_tpu_torch.apps import example_step as ex
from rfs_slam_tpu_torch.core.state import GMState
from rfs_slam_tpu_torch.ops import gm as gm_ops
from rfs_slam_tpu_torch.ops.kernels import build
from rfs_slam_tpu_torch.ops.kernels import map_update2d as mu
from rfs_slam_tpu_torch.ops.kernels import merge2d as m2
from rfs_slam_tpu_torch.ops.kernels import merge3d as m3
from tests.test_torch_map_update import assert_twin_matches_xla
from tests.torch_parity import CPU, assert_gm_close, jax_gm, step_draws, t

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P, M, ZC = 4, 1056, 8     # past 1,024 slots, small enough for the CPU


def words(n):
    return -(-n // 32)


# the parent's plans of the small forms, from their documented layouts
SMALL_PLANS = (
    [("map_update2d", (200, 128, 40)), ("map_update2d", (100, 512, 24)),
     ("map_update2d", (200, 1024, 40))]
    + [(k, (200, n)) for k in ("merge2d", "merge3d")
       for n in (100, 128, 512, 1024)])
LARGE_PLANS = ([("map_update2d", (64, m, zc)) for m in (1025, 2048, 4096,
                                                         8192)
                for zc in (16, 40)]
               + [(k, (64, n)) for k in ("merge2d", "merge3d")
                  for n in (1025, 2048, 4096, 8192)])


def small_plan(kernel, shape):
    if kernel == "map_update2d":
        p, m, zc = shape
        zb = max(1, min(zc, mu.TABLE_BYTES // (4 * m)))
        warps = min(16, max(words(m), zb))
        return (32 * warps, 4 * (3 * zc + 10 * m + words(m) + zb * m), zb,
                "small", 0)
    _, n = shape
    planes, threads = ((12, max(512, 32 * words(n))) if kernel == "merge2d"
                       else (19, 1024))
    return threads, 4 * (planes * n + n * words(n) + words(n)), "small", 0


def plan_of(kernel, shape):
    if kernel == "map_update2d":
        return mu.launch_plan(*shape, 8)
    return {"merge2d": m2, "merge3d": m3}[kernel].launch_plan(*shape)


@pytest.mark.parametrize("kernel,shape", SMALL_PLANS + LARGE_PLANS)
def test_launch_plans(kernel, shape):
    """At M (N) <= 1,024 each launch plan is the parent's (threads, shared
    memory, zb), in the small form without a workspace.  Above, the large
    form: shared memory within Hopper's limit, a multiple of 32 threads
    within the kernel's bound, and the workspace as documented: the merge
    kernels' shared-memory layout per particle, each rounded up to 16
    bytes; the map update's 10 stash planes where the stash no longer fits
    in shared memory."""
    plan = plan_of(kernel, shape)
    if shape[1] <= 1024:
        assert tuple(plan) == small_plan(kernel, shape)
        return
    assert plan.form == "large" and plan.smem <= build.MAX_SMEM
    assert plan.threads % 32 == 0
    n = shape[1]
    if kernel == "map_update2d":
        p, m, zc = shape
        assert 32 <= plan.threads <= mu.MAX_THREADS
        zb = max(1, min(zc, mu.TABLE_BYTES // (4 * m)))
        assert plan.zb == zb
        picks = 16 * 32 * -(-m // 1024)
        with_stash = 4 * (3 * zc + 10 * m + words(m) + zb * m + picks)
        if with_stash <= build.MAX_SMEM:
            assert (plan.smem, plan.workspace) == (with_stash, 0)
        else:
            assert plan.smem == with_stash - 40 * m
            assert plan.workspace == 40 * p * m
    else:
        planes = 12 if kernel == "merge2d" else 19
        assert plan.threads == 1024 and plan.smem == 0
        layout = 4 * (planes * n + n * words(n) + words(n))
        assert plan.workspace == shape[0] * -(-layout // 16) * 16
        # the mask dominates: ~512 MiB at P=64, N=8,192 for merge2d
        assert plan.workspace >= shape[0] * 4 * n * words(n)


def mixture_np(rng, D, P_, N, alive_range, spread=3.0):
    """Random D-dimensional mixtures (tests/test_pallas_merge*.py's), the
    first 609-624 (``alive_range``) slots of each particle alive."""
    mean = rng.uniform(-spread, spread, size=(P_, N, D)).astype(np.float32)
    if D == 3:
        mean[..., 2] = rng.uniform(0.2, 1.0, size=(P_, N))
    A = rng.normal(size=(P_, N, D, D)).astype(np.float32) * 0.2
    cov = A @ np.swapaxes(A, -1, -2) + 0.3 * np.eye(D, dtype=np.float32)
    w = rng.uniform(0.1, 1.0, size=(P_, N)).astype(np.float32)
    alive = np.arange(N)[None, :] < rng.integers(*alive_range, (P_, 1))
    return dict(mean=np.moveaxis(mean, -1, 0).copy(),
                cov=np.stack([cov[..., i, j] for i in range(D)
                              for j in range(i, D)]),
                w=w, w_prev=w * 0.5, alive=alive)


@pytest.mark.parametrize("D,P_", [(2, 4), (3, 2)])
def test_merge_twin_matches_jax_past_1024_slots(rng, D, P_):
    """gm.merge on CPU tensors (the twin of merge2d / merge3d) against the
    JAX package's XLA merge at N=1,056, 609-624 alive slots a particle:
    alive sets equal, floats within tests/test_pallas_merge*.py's
    tolerances."""
    d = mixture_np(rng, D, P_, M, (609, 625))
    want = jgm.merge(jax_gm(d), threshold=1.5, f_inflation=1.5,
                     impl="xla")
    kernel = m2 if D == 2 else m3
    before = kernel.launches
    out = gm_ops.merge(GMState(**{k: t(v) for k, v in d.items()}), 1.5, 1.5)
    assert kernel.launches == before      # CPU tensors: the twin ran
    a = np.asarray(want.alive)
    np.testing.assert_array_equal(out.alive.numpy(), a)
    assert a.sum() < d["alive"].sum()     # merges happened
    np.testing.assert_allclose(out.w.numpy()[a], np.asarray(want.w)[a],
                               rtol=1e-5)
    np.testing.assert_allclose(out.mean.numpy()[:, a],
                               np.asarray(want.mean)[:, a], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(out.cov.numpy()[:, a],
                               np.asarray(want.cov)[:, a], rtol=1e-3,
                               atol=1e-4 if D == 3 else 1e-5)
    np.testing.assert_allclose(out.w_prev.numpy()[a],
                               np.asarray(want.w_prev)[a], rtol=1e-5)


@pytest.fixture(scope="module")
def example():
    """The JAX example filter and inputs at P=4, M=1,056, Zc=8, and the
    port's, each from its own ``_build`` / ``_example_inputs``."""
    jfilt = _build(n_particles=P, map_capacity=M, z_capacity=ZC,
                   new_capacity=32, eval_capacity=8, z_dp_max=6)
    jstate, odo, z, z_mask = _example_inputs(jfilt, jax.random.PRNGKey(0))
    filt = ex.build(P, M, ZC, CPU)
    return jfilt, (jstate, odo, z, z_mask), filt, ex.example_inputs(filt,
                                                                    CPU)


def test_example_inputs_match_jax(example):
    """The port's example state and inputs are JAX's: the ring's means
    within 1e-6 (XLA may round the ring's angles an ulp apart, 4.8e-7 at
    2 pi, and cos and sin round apart), the measurements within an ulp,
    everything else equal; the port's filter is wired as JAX's."""
    jfilt, (jstate, jodo, jz, jzm), filt, (state, odo, z, z_mask) = example
    got, want = convert.to_numpy(state), jstate
    for k in ("cov", "w", "w_prev", "alive"):
        np.testing.assert_array_equal(got["gm"][k],
                                      np.asarray(getattr(want.gm, k)), k)
    np.testing.assert_allclose(got["gm"]["mean"], np.asarray(want.gm.mean),
                               rtol=0, atol=1e-6)
    for k in ("pose", "log_w", "parent"):
        np.testing.assert_array_equal(got["particles"][k],
                                      np.asarray(getattr(want.particles, k)))
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=0, atol=2e-7)
    np.testing.assert_array_equal(z_mask.numpy(), np.asarray(jzm))
    np.testing.assert_array_equal(odo.numpy(), np.asarray(jodo))
    assert filt.cfg == convert.from_numpy(type(filt.cfg), jfilt.cfg, CPU)
    assert filt._map_params == convert.filter_from_numpy(
        jfilt, CPU)._map_params


def test_example_step_matches_jax(example):
    """One predict + update from the port's example inputs against JAX's
    jitted step from its own, with JAX's motion draws and resampling
    offset: alive and parent equal, floats within tests/
    test_torch_filter.py's tolerances.  The ring merges to a few slots a
    particle over many passes."""
    jfilt, (jstate, jodo, jz, jzm), filt, (state, odo, z, z_mask) = example

    @jax.jit
    def jstep(s, o, zz, zm):
        return jfilt.update(jfilt.predict(s, o, ex.DT), zz, zm)

    noise, u0 = step_draws(jstate.particles.key, P)
    want = jstep(jstate, jodo, jz, jzm)
    got = filt.update(filt.predict(state, odo, ex.DT, noise=t(noise)), z,
                      z_mask, u0=t(u0))
    np.testing.assert_array_equal(got.particles.parent.numpy(),
                                  np.asarray(want.particles.parent))
    np.testing.assert_allclose(got.particles.pose.numpy(),
                               np.asarray(want.particles.pose), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got.particles.log_w.numpy(),
                               np.asarray(want.particles.log_w), rtol=1e-4,
                               atol=1e-4)
    assert_gm_close(got.gm, want.gm)
    alive = got.gm.alive.sum(dim=1)
    assert int(alive.max()) < M // 8     # the ring of 528 merged down


def test_map_update_twin_matches_xla_past_1024_slots(example):
    """The 2-D map update's twin against the JAX package's XLA head
    (tests/test_map_update_fused.py's formulas and tolerances) on the
    example state at M=1,056, predicted one step."""
    jfilt, _, filt, (state, odo, z, z_mask) = example
    state = filt.predict(state, odo, ex.DT,
                         gen=torch.Generator().manual_seed(0))
    assert_twin_matches_xla(jfilt, filt, state, z, z_mask)


def test_overflow_demo_mesh_on_gloo_ranks():
    """``python -m rfs_slam_tpu_torch.parallel.map_overflow_demo mesh`` on a
    1 x 2 particles x map mesh of gloo ranks at P=4, M=1,056, Zc=8, 2
    steps: it finishes within its limit and the gathered state is
    finite."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-m", "rfs_slam_tpu_torch.parallel.map_overflow_demo",
         "mesh", "--device", "cpu", "--particles", str(P), "--map", str(M),
         "--zc", str(ZC), "--steps", "2", "--mesh-shape", "1", "2",
         "--timeout", "200"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["finite"] and rec["mesh"] == [1, 2]
    assert [r["m_local"] for r in rec["ranks"]] == [M // 2] * 2
    assert all(r["backend"] == "gloo" and r["bytes_per_step"] > 0
               for r in rec["ranks"])
    assert rec["forms"]["merge2d"]["form"] == "large"
