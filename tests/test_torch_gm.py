"""rfs_slam_tpu_torch GM ops and the merge2d twin against the JAX package:
merge (pure JAX and the Pallas kernel in interpret mode), the per-particle
alive bound of the CUDA kernel, mass conservation, replace_weakest, and the
tie order of every top-k."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rfs_slam_tpu.ops import gm as jgm
from rfs_slam_tpu.ops.pallas.merge2d import merge2d as jmerge2d
from rfs_slam_tpu_torch.core import planar
from rfs_slam_tpu_torch.core.state import GMState
from rfs_slam_tpu_torch.ops import gm as gm_ops
from rfs_slam_tpu_torch.ops.kernels import merge2d as merge2d_mod
from tests.torch_parity import assert_gm_close, jax_gm, t


def random_gm_np(rng, P=4, N=128, n_alive=20, spread=3.0):
    mean = rng.uniform(-spread, spread, size=(2, P, N)).astype(np.float32)
    A = rng.normal(size=(P, N, 2, 2)).astype(np.float32) * 0.2
    cov = A @ np.swapaxes(A, -1, -2) + 0.3 * np.eye(2, dtype=np.float32)
    w = rng.uniform(0.1, 1.0, size=(P, N)).astype(np.float32)
    alive = np.zeros((P, N), bool)
    alive[:, :n_alive] = True
    return dict(mean=mean,
                cov=np.stack([cov[..., 0, 0], cov[..., 0, 1],
                              cov[..., 1, 1]]),
                w=w, w_prev=w * 0.5, alive=alive)


def port_gm(d):
    return GMState(**{k: t(v) for k, v in d.items()})


def assert_merge_matches_jax(d, threshold=1.5, f_inflation=1.5):
    """gm.merge on the port (the twin, CPU tensors) against gm.merge (pure
    JAX) and merge2d (Pallas, interpret mode) on the same numpy inputs,
    with the float tolerances of tests/test_pallas_merge.py."""
    N = d["w"].shape[1]
    ref = jgm.merge(jax_gm(d), threshold=threshold, f_inflation=f_inflation)
    pal = jmerge2d(jgm.compact(jax_gm(d), N), threshold, f_inflation,
                   interpret=True)
    launches = merge2d_mod.launches
    out = gm_ops.merge(port_gm(d), threshold, f_inflation)
    assert merge2d_mod.launches == launches   # CPU tensors: the twin ran
    for want in (ref, pal):
        a = np.asarray(want.alive)
        np.testing.assert_array_equal(out.alive.numpy(), a)
        np.testing.assert_allclose(out.w.numpy()[a], np.asarray(want.w)[a],
                                   rtol=1e-5)
        np.testing.assert_allclose(out.mean.numpy()[:, a],
                                   np.asarray(want.mean)[:, a],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(out.cov.numpy()[:, a],
                                   np.asarray(want.cov)[:, a],
                                   rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(out.w_prev.numpy()[a],
                                   np.asarray(want.w_prev)[a], rtol=1e-5)
    return out


@pytest.mark.parametrize("n_alive", [20, 90])
def test_merge_twin_matches_jax_merge_and_pallas(rng, n_alive):
    """The twin against gm.merge (pure JAX) and merge2d (Pallas, interpret
    mode), with the float tolerances of tests/test_pallas_merge.py."""
    out = assert_merge_matches_jax(random_gm_np(rng, n_alive=n_alive))
    assert out.alive.sum() < n_alive * 4       # merges happened


def edge_gm_np(rng, case):
    """The mixtures the CUDA kernel's gate bit mask hinges on."""
    if case == "word boundary":
        # far-apart slots, and two gated chains (0.25 apart: neighbours in
        # the gate, slots two apart not) across 32-slot word boundaries;
        # descending weights keep the slot order through compact
        d = random_gm_np(rng, P=2, N=128, n_alive=100, spread=40.0)
        d["cov"] = np.stack([np.full((2, 128), 0.04, np.float32),
                             np.zeros((2, 128), np.float32),
                             np.full((2, 128), 0.04, np.float32)])
        d["w"] = np.tile(np.linspace(1.0, 0.2, 128, dtype=np.float32), (2, 1))
        d["w_prev"] = d["w"] * 0.5
        for s0 in (30, 62):
            d["mean"][0, :, s0:s0 + 5] = 0.25 * np.arange(5) + s0
            d["mean"][1, :, s0:s0 + 5] = 0.0
        return d
    if case == "all alive":
        return random_gm_np(rng, N=128, n_alive=128)
    if case == "N=100":
        return random_gm_np(rng, N=100, n_alive=70)
    d = random_gm_np(rng, n_alive=60)          # "empty particle"
    d["alive"][1] = False
    return d


@pytest.mark.parametrize("case", ["word boundary", "all alive", "N=100",
                                  "empty particle"])
def test_merge_twin_matches_jax_edges(rng, case):
    """Gated chains across 32-slot words (slots 30-34 and 62-66), every
    slot alive (the alive bound is N), N not a multiple of 32, and a
    particle with no alive slot."""
    d = edge_gm_np(rng, case)
    out = assert_merge_matches_jax(d)
    if case == "word boundary":
        # over three passes each chain of five ends as two slots
        for s0 in (30, 62):
            assert out.alive[:, s0:s0 + 5].sum(dim=1).tolist() == [2, 2]
    if case == "empty particle":
        assert not out.alive[1].any()
    assert out.alive.sum() < d["alive"].sum()  # merges happened


def test_launch_plan_fits_every_size():
    """Every N up to SMALL_SLOTS launches in the small form within Hopper's
    limits, with one thread per slot (the large form's plans:
    tests/test_torch_large_map.py)."""
    for N in range(1, merge2d_mod.SMALL_SLOTS + 1):
        threads, smem, form, workspace = merge2d_mod.launch_plan(200, N)
        assert threads % 32 == 0 and N <= threads <= 1024
        assert smem <= 232_448 and (form, workspace) == ("small", 0)
    assert merge2d_mod.launch_plan(200, 128) == (512, 4 * (12 * 128 + 128 * 4
                                                           + 4), "small", 0)


# 262,144 slots: a particle's mask past the kernel's 32-bit index
@pytest.mark.parametrize("P,N", [(200, 1 << 18), (200, 0), (0, 128)])
def test_launch_plan_rejects(P, N):
    with pytest.raises(ValueError):
        merge2d_mod.launch_plan(P, N)


@pytest.mark.parametrize("n_alive", [17, 40, 77])
def test_merge_alive_bound_matches_full_axis(rng, n_alive):
    """The CUDA kernel bounds each particle's pair search by one past its
    highest alive slot.  Merging only the slots below that bound gives the
    same result as merging the full capacity, and slots never come alive."""
    d = random_gm_np(rng, n_alive=n_alive, spread=1.5)
    gm = gm_ops.compact(port_gm(d), 128)
    full = gm_ops.merge_fixpoint(gm, 1.5, 1.5)
    hi = int(gm.alive.sum(dim=1).max())
    cut = GMState(gm.mean[..., :hi], gm.cov[..., :hi], gm.w[:, :hi],
                  gm.w_prev[:, :hi], gm.alive[:, :hi])
    part = gm_ops.merge_fixpoint(cut, 1.5, 1.5)
    for f in ("mean", "cov", "w", "w_prev", "alive"):
        np.testing.assert_array_equal(getattr(full, f)[..., :hi].numpy(),
                                      getattr(part, f).numpy(), err_msg=f)
        np.testing.assert_array_equal(getattr(full, f)[..., hi:].numpy(),
                                      getattr(gm, f)[..., hi:].numpy())
    assert not full.alive[:, hi:].any()


def test_merge_conserves_mass_in_broken_chain():
    """k-x gated, x-j gated, k-j not: the safe-absorber rule defers x, so
    j's mass is not lost (tests/test_gm_ops.py's case)."""
    S = [0.04, 0.0, 0.04]
    mean = np.zeros((2, 1, 4), np.float32)
    mean[0, 0, :3] = [0.0, 0.5, 1.0]
    d = dict(mean=mean, cov=np.tile(np.float32(S)[:, None, None], (1, 1, 4)),
             w=np.float32([[0.5, 0.3, 0.2, 0.0]]), w_prev=np.zeros((1, 4),
                                                                  np.float32),
             alive=np.array([[True, True, True, False]]))
    out = gm_ops.merge(port_gm(d), threshold=3.0, f_inflation=1.0)
    total = float(out.w[out.alive].sum())
    np.testing.assert_allclose(total, 1.0, rtol=1e-5)
    ref = jgm.merge(jax_gm(d), threshold=3.0, f_inflation=1.0)
    assert_gm_close(out, ref)


def test_merge_conserves_mass_random(rng):
    for _ in range(3):
        d = random_gm_np(rng, P=3, N=24, n_alive=20, spread=1.5)
        d["alive"] = rng.uniform(size=(3, 24)) < 0.8
        out = gm_ops.merge(port_gm(d), threshold=1.5, f_inflation=1.5)
        before = (d["w"] * d["alive"]).sum(axis=1)
        after = torch.where(out.alive, out.w, 0.0).sum(dim=1).numpy()
        np.testing.assert_allclose(after, before, rtol=1e-4)


@pytest.mark.parametrize("K", [5, 7])
def test_replace_weakest_matches_jax_append_compact(rng, K):
    """replace_weakest == top-capacity of the union (JAX append + compact),
    and equals the JAX replace_weakest slot for slot."""
    P, M = 4, 6
    d = random_gm_np(rng, P=P, N=M, n_alive=M)
    d["alive"] = rng.uniform(size=(P, M)) < 0.8
    d["w_prev"] = np.zeros_like(d["w"])
    new = random_gm_np(rng, P=P, N=K, n_alive=K)
    n_alive = rng.uniform(size=(P, K)) < 0.7
    args_j = (jnp.asarray(new["mean"]), jnp.asarray(new["cov"]),
              jnp.asarray(new["w"]), jnp.asarray(n_alive))
    ref = jgm.append(jax_gm(d), *args_j)
    same = jgm.replace_weakest(jax_gm(d), *args_j)
    out = gm_ops.replace_weakest(port_gm(d), t(new["mean"]), t(new["cov"]),
                                 t(new["w"]), t(n_alive))
    assert_gm_close(out, same, rtol=0, atol=0)
    for p in range(P):
        ra, oa = np.asarray(ref.alive[p]), out.alive[p].numpy()
        assert ra.sum() == oa.sum()
        np.testing.assert_allclose(np.sort(out.w[p].numpy()[oa]),
                                   np.sort(np.asarray(ref.w[p])[ra]))


def test_prune_matches_jax(rng):
    d = random_gm_np(rng, P=3, N=10, n_alive=8)
    np.testing.assert_array_equal(
        gm_ops.prune(port_gm(d), 0.5).alive.numpy(),
        np.asarray(jgm.prune(jax_gm(d), 0.5).alive))


def test_topk_tie_order_matches_jax():
    """jax.lax.top_k puts the lower index first among equal values;
    torch.topk does not promise that, topk_stable does."""
    row = np.full((1, 18), 0.01, np.float32)
    row[0, [6, 10, 14]] = 0.5
    row[0, [3, 5]] = -np.inf
    _, want = jax.lax.top_k(row, 8)
    _, got = planar.topk_stable(t(row), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy()[0, :4], [6, 10, 14, 0])
    _, want_lo = jax.lax.top_k(-row, 8)
    _, got_lo = planar.topk_stable(t(row), 8, largest=False)
    np.testing.assert_array_equal(got_lo.numpy(), np.asarray(want_lo))


def test_compact_and_replace_weakest_tie_order_match_jax(rng):
    """Births all enter at one weight and dead slots all score -inf: slot
    order after compact and replace_weakest must equal the JAX package's,
    because the merge claims pairs lowest index first."""
    P, M, K = 3, 12, 6
    d = random_gm_np(rng, P=P, N=M, n_alive=M)
    d["w"][:] = 0.01
    d["w"][:, [2, 7]] = 0.3
    d["alive"] = rng.uniform(size=(P, M)) < 0.7
    got = gm_ops.compact(port_gm(d), M)
    assert_gm_close(got, jgm.compact(jax_gm(d), M), rtol=0, atol=0)
    np.testing.assert_array_equal(got.mean.numpy(),
                                  np.asarray(jgm.compact(jax_gm(d), M).mean))
    new = random_gm_np(rng, P=P, N=K, n_alive=K)
    w_new = np.full((P, K), 0.01, np.float32)
    a_new = rng.uniform(size=(P, K)) < 0.8
    want = jgm.replace_weakest(jax_gm(d), jnp.asarray(new["mean"]),
                               jnp.asarray(new["cov"]), jnp.asarray(w_new),
                               jnp.asarray(a_new))
    got = gm_ops.replace_weakest(port_gm(d), t(new["mean"]), t(new["cov"]),
                                 t(w_new), t(a_new))
    for f in ("mean", "cov", "w", "w_prev", "alive"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


def test_take_slots_matches_jax(rng):
    d = random_gm_np(rng, P=3, N=9, n_alive=9)
    idx = rng.integers(0, 9, size=(3, 4))
    got = gm_ops.take_slots(port_gm(d), t(idx))
    want = jgm.take_slots(jax_gm(d), jnp.asarray(idx))
    for f in ("mean", "cov", "w", "w_prev", "alive"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
