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
                  for n in (1025, 2048, 4096, 8192)]
               + [("merge2d", (2, 12288)), ("merge2d", (1, 53248))]
               # merge3d's tiers: all in shared memory up to 5,756 slots
               # (and at Victoria Park's P=100 padded to 2,048), the gate
               # fields in the workspace up to 53,125, then all of it
               + [("merge3d", (100, 2048))]
               + [("merge3d", (64, n)) for n in (5756, 5757, 53125, 53126)])
H100_SMS = 132   # an H100 SXM's SMs


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
        return mu.launch_plan(*shape, 8, H100_SMS)
    return {"merge2d": m2, "merge3d": m3}[kernel].launch_plan(*shape)


@pytest.mark.parametrize("kernel,shape", SMALL_PLANS + LARGE_PLANS)
def test_launch_plans(kernel, shape):
    """At M (N) <= 1,024 each launch plan is the parent's (threads, shared
    memory, zb), in the small form without a workspace.  Above, the large
    form within Hopper's limit, as documented.  merge2d: no mask; a
    16-byte header, 20 bytes of gate fields and 4 of claims a slot and
    three words per 32 slots (the alive bits, the safe bits, the list of
    safe words) in shared memory, no workspace up to 9,535 slots (199,696
    B at N=8,192, where the mask form took 562,102,272 B of workspace at
    P=64); past that the gate fields in the workspace, and past 53,125
    slots all of it.  merge3d: the same layout with 36 bytes of gate
    fields a slot, no workspace up to 5,756 slots (82,704 B at N=2,048,
    where the mask form took 68,019,200 B of workspace at P=100); each
    particle's part of a workspace rounded up to 16 bytes.  map_update2d:
    512 threads; shared memory (Hopper's limit at 64 particles on a card
    of 132 SMs, each CTA with an SM of its own; 113 KB where the SMs are
    not known) holds the fixed part (4 words a measurement, two bit words
    per 32 slots, a word a thread) and, for a list of 32 ceil(M / 32)
    entries, the 11-word stash and a column, with no workspace; or, where
    that does not fit, a column, and a workspace for the stash of every
    entry, 44 bytes each."""
    plan = plan_of(kernel, shape)
    if shape[1] <= 1024:
        assert tuple(plan) == small_plan(kernel, shape)
        return
    assert plan.form == "large" and plan.smem <= build.MAX_SMEM
    assert plan.threads % 32 == 0
    n = shape[1]
    if kernel == "map_update2d":
        p, m, zc = shape
        assert plan.threads == mu.MAX_THREADS
        assert mu.launch_plan(*shape, 8).smem <= mu.LARGE_SMEM
        fixed = 4 * zc + 2 * words(m) + mu.MAX_THREADS
        room = plan.smem // 4 - fixed     # words for the stash and table
        n = 32 * words(m)                 # the list's most entries
        if 4 * (fixed + 12 * n) <= build.MAX_SMEM:
            assert plan.workspace == 0
            # the stash of every entry and a column, no more than the whole
            # table beside it needs
            assert 12 * n <= room <= max(12, 11 + zc) * n
            assert plan.zb == min(zc, (room - 11 * n) // n) >= 1
        else:
            assert plan.workspace == 44 * p * n
            assert n <= room <= max(1, zc) * n
            assert plan.zb == min(zc, room // n) >= 1
    else:
        p = shape[0]
        assert plan.threads == 1024
        field_bytes, all_shared = ((20, 9535) if kernel == "merge2d"
                                   else (36, 5756))
        fields, claims = field_bytes * n, 4 * n + 12 * words(n)
        # the tiers' boundaries, from the layout
        assert (16 + fields + claims <= build.MAX_SMEM) == (n <= all_shared)
        assert (16 + claims <= build.MAX_SMEM) == (n <= 53125)
        if n <= all_shared:
            assert plan.smem == 16 + fields + claims and plan.workspace == 0
        elif n <= 53125:
            assert plan.smem == 16 + claims
            assert plan.workspace == p * -(-fields // 16) * 16
        else:
            assert plan.smem == 16
            assert plan.workspace == p * -(-(fields + claims) // 16) * 16
        if (kernel, n) == ("merge2d", 8192):
            assert plan.smem == 199_696
        if (kernel, n) == ("merge3d", 2048):
            assert plan.smem == 82_704


def sweeps(gate, alive):
    """A numpy model of the merges' large-form search on one particle
    (``csrc/merge_bitmask.cuh``), word by word as a warp walks it.  Sweep
    A (``safe_sweep``; ``safe_sweep2`` walks two rows at once, each as
    here) walks a row's words down from the top one, skips words with no
    alive slot and stops at the first word whose ballot over the alive
    lanes k < j holds a gated pair.  The claims
    (``claim_sweep``): each unsafe row walks the list of words holding a
    safe slot (``safe_words``) up to j, tests only the safe lanes and takes
    the lowest lane of the first word with a hit; each absorber keeps its
    lowest claiming row.  ``gate [k, j]``: the pair's two-way test.  Returns ``(first_i [j], j_star [i])``, N where none."""
    N = len(alive)
    hi = int(np.nonzero(alive)[0].max()) + 1 if alive.any() else 0
    lanes = np.arange(32)

    def word(bits, w):
        k = 32 * w + lanes
        return k, np.where(k < N, bits[np.minimum(k, N - 1)], False)

    safe = np.zeros(N, bool)
    for j in range(hi):
        if not alive[j]:
            continue
        found = False
        for w in reversed(range(words(j))):
            k, ak = word(alive, w)
            if not ak.any():
                continue
            if (ak & (k < j) & gate[np.minimum(k, N - 1), j]).any():
                found = True
                break
        safe[j] = not found
    first = np.full(N, N)
    j_star = np.full(N, N)
    listed = [w for w in range(words(hi)) if word(safe, w)[1].any()]
    for j in np.nonzero(alive & ~safe)[0]:
        for w in listed:
            if 32 * w >= j:
                break
            k, sk = word(safe, w)
            hit = sk & (k < j) & gate[np.minimum(k, N - 1), j]
            if hit.any():
                first[j] = 32 * w + int(np.argmax(hit))
                break
    for j in np.nonzero(first < N)[0]:
        j_star[first[j]] = min(j_star[first[j]], j)
    return first, j_star


@pytest.mark.parametrize("D", [2, 3])
def test_merge2d_sweeps_match_twin(rng, D):
    """The model of the mask-free search (:func:`sweeps`) picks exactly
    the twin's ``first_i`` and ``j_star`` (``ops/gm.py::_merge_pairs``,
    the pair choice of ``_merge_pass``) on every pass of the fixpoint, with
    merge2d's gate (D=2) and merge3d's (D=3): random mixtures crowded
    enough to merge, and chains gated across 32-slot words, at N=160 (five
    words) with dead slots between alive ones in later passes."""
    d = mixture_np(rng, D, 6, 160, (60, 161), spread=1.2)
    mean, alive = d["mean"], d["alive"]
    eye = np.array([1.0 if r == c else 0.0 for r in range(D)
                    for c in range(r, D)])
    # chains across words 0-1, 1-2 and 2-3
    for p, s0 in ((4, 28), (5, 60), (3, 90)):
        mean[:, p, s0:s0 + 9] = 0.0
        mean[0, p, s0:s0 + 9] = 0.3 * np.arange(9)
        if D == 3:
            mean[2, p, s0:s0 + 9] = 0.5
        d["cov"][:, p, s0:s0 + 9] = 0.05 * eye[:, None]
        alive[p, :s0 + 9] = True
    gm = GMState(**{k: t(v) for k, v in d.items()})
    passes = 0
    for _ in range(8):
        gate, first_i, j_star = gm_ops._merge_pairs(gm, 1.5 * 1.5)
        for p in range(gm.w.shape[0]):
            a = gm.alive[p].numpy()
            f, js = sweeps(gate[p].numpy(), a)
            np.testing.assert_array_equal(f[a], first_i[p].numpy()[a])
            np.testing.assert_array_equal(js, j_star[p].numpy())
        gm, n = gm_ops._merge_pass(gm, 1.5 * 1.5, 1.5)
        passes += 1
        if int(n) == 0:
            break
    assert passes >= 3                     # chains take several passes


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
