"""The merge3d twin (rfs_slam_tpu_torch.ops.gm.merge on D=3 CPU tensors)
against the JAX package: the pure-JAX merge (XLA) and the Pallas merge3d in
interpret mode, at P=3, N=128, with the float tolerances of
tests/test_pallas_merge3d.py; gated chains across 32-slot words, the CUDA
kernel's alive bound and launch plan, mass conservation, the no-pair case,
zero-weight pairs, and the dispatch."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rfs_slam_tpu.core.state import GMState as JGMState
from rfs_slam_tpu.ops import gm as jgm
from rfs_slam_tpu.ops.pallas.merge3d import merge3d as jmerge3d
from rfs_slam_tpu_torch.core.state import GMState
from rfs_slam_tpu_torch.ops import gm as gm_ops
from rfs_slam_tpu_torch.ops.kernels import merge2d as merge2d_mod
from rfs_slam_tpu_torch.ops.kernels import merge3d as merge3d_mod
from tests.torch_parity import assert_gm_close, jax_gm, t


def random_gm3_np(rng, P=3, N=128, n_alive=24, spread=3.0):
    """tests/test_pallas_merge3d.py's mixtures, as packed planes."""
    mean = rng.uniform(-spread, spread, size=(P, N, 3)).astype(np.float32)
    mean[..., 2] = rng.uniform(0.2, 1.0, size=(P, N))  # tree diameters
    A = rng.normal(size=(P, N, 3, 3)).astype(np.float32) * 0.2
    cov = A @ np.swapaxes(A, -1, -2) + 0.3 * np.eye(3, dtype=np.float32)
    w = rng.uniform(0.1, 1.0, size=(P, N)).astype(np.float32)
    alive = np.zeros((P, N), bool)
    alive[:, :n_alive] = True
    return dict(mean=np.moveaxis(mean, -1, 0).copy(),
                cov=np.stack([cov[..., i, j] for i in range(3)
                              for j in range(i, 3)]),
                w=w, w_prev=w * 0.5, alive=alive)


def port_gm(d):
    return GMState(**{k: t(v) for k, v in d.items()})


def assert_merged_close(out, want):
    """Alive exact; w, w_prev rtol 1e-5, mean rtol 1e-4 / atol 1e-5, cov
    rtol 1e-3 / atol 1e-4 on alive slots (test_pallas_merge3d.py)."""
    a = np.asarray(want.alive)
    np.testing.assert_array_equal(out.alive.numpy(), a)
    np.testing.assert_allclose(out.w.numpy()[a], np.asarray(want.w)[a],
                               rtol=1e-5)
    np.testing.assert_allclose(out.mean.numpy()[:, a],
                               np.asarray(want.mean)[:, a], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(out.cov.numpy()[:, a],
                               np.asarray(want.cov)[:, a], rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(out.w_prev.numpy()[a],
                               np.asarray(want.w_prev)[a], rtol=1e-5)


@pytest.mark.parametrize("n_alive", [24, 90])
def test_merge3d_twin_matches_jax_merge_and_pallas(rng, n_alive):
    d = random_gm3_np(rng, n_alive=n_alive)
    ref = jgm.merge(jax_gm(d), threshold=1.5, f_inflation=1.5)
    pal = jmerge3d(jgm.compact(jax_gm(d), 128), 1.5, 1.5, interpret=True)
    launches = merge3d_mod.launches
    out = gm_ops.merge(port_gm(d), 1.5, 1.5)
    assert merge3d_mod.launches == launches   # CPU tensors: the twin ran
    for want in (ref, pal):
        assert_merged_close(out, want)
    assert out.alive.sum() < n_alive * 3       # merges happened


def test_merge3d_twin_chains_across_words_match_jax_merge(rng):
    """Gated chains across 32-slot words (slots 30-34 and 62-66, 0.25
    apart under a covariance of 0.04: neighbours gated, slots two apart
    not) among far-apart slots, 100 of 128 alive: the twin against the
    XLA merge; over three passes each chain of five ends as two slots."""
    d = random_gm3_np(rng, n_alive=100, spread=40.0)
    d["cov"] = np.zeros((6, 3, 128), np.float32)
    d["cov"][[0, 3, 5]] = 0.04
    d["w"] = np.tile(np.linspace(1.0, 0.2, 128, dtype=np.float32), (3, 1))
    d["w_prev"] = d["w"] * 0.5
    d["mean"][2] = 0.5
    for s0 in (30, 62):
        d["mean"][0, :, s0:s0 + 5] = 0.25 * np.arange(5) + s0
        d["mean"][1, :, s0:s0 + 5] = 0.0
    out = gm_ops.merge(port_gm(d), 1.5, 1.5)
    assert_merged_close(out, jgm.merge(jax_gm(d), threshold=1.5,
                                       f_inflation=1.5))
    for s0 in (30, 62):
        assert out.alive[:, s0:s0 + 5].sum(dim=1).tolist() == [2, 2, 2]


def test_merge3d_launch_plan_fits_every_size():
    """Every N up to SMALL_SLOTS launches in the small form within Hopper's
    limits, with one thread per slot; at N=512 the layout is 19 slot
    planes, a 512 x 16 word mask and 16 safe words (the large form's
    plans: tests/test_torch_large_map.py)."""
    for N in range(1, merge3d_mod.SMALL_SLOTS + 1):
        threads, smem, form, workspace = merge3d_mod.launch_plan(100, N)
        assert threads % 32 == 0 and N <= threads <= 1024
        assert smem <= 232_448 and (form, workspace) == ("small", 0)
    assert merge3d_mod.launch_plan(100, 512) == (
        1024, 4 * (19 * 512 + 512 * 16 + 16), "small", 0)


# 262,144 slots: a particle's mask past the kernel's 32-bit index
@pytest.mark.parametrize("P,N", [(100, 1 << 18), (100, 0), (0, 512)])
def test_merge3d_launch_plan_rejects(P, N):
    with pytest.raises(ValueError):
        merge3d_mod.launch_plan(P, N)


@pytest.mark.parametrize("n_alive", [17, 40, 77])
def test_merge3d_alive_bound_matches_full_axis(rng, n_alive):
    """The CUDA kernel bounds each particle's pair search by one past its
    highest alive slot: merging only the slots below it gives the full
    capacity's result, and no slot comes alive."""
    d = random_gm3_np(rng, n_alive=n_alive, spread=1.5)
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


def test_merge3d_mass_conserved(rng):
    d = random_gm3_np(rng, n_alive=40)
    out = gm_ops.merge(port_gm(d), 2.0, 1.0)
    before = (d["w"] * d["alive"]).sum(axis=1)
    after = torch.where(out.alive, out.w, 0.0).sum(dim=1).numpy()
    np.testing.assert_allclose(after, before, rtol=1e-5)
    assert int(out.alive.sum()) < int(d["alive"].sum())


def test_merge3d_no_pairs(rng):
    """Far-apart components (test_pallas_merge3d.py::test_pallas_merge3d_no
    _pairs): nothing merges; the output is the weight-sorted input
    exactly."""
    d = random_gm3_np(rng, n_alive=5)
    d["mean"] = d["mean"] * 100.0
    out = gm_ops.merge(port_gm(d), 0.5, 1.5)
    sorted_in = gm_ops.compact(port_gm(d), 128)
    for f in ("mean", "cov", "w", "w_prev", "alive"):
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      getattr(sorted_in, f).numpy())
    want = jmerge3d(JGMState(**{k: jnp.asarray(v) for k, v in d.items()}),
                    0.5, 1.5, interpret=True)
    np.testing.assert_array_equal(out.alive.numpy(), np.asarray(want.alive))


def test_merge3d_zero_weight_pair_keeps_both():
    """Two gated alive slots with w = 0: the twin (and the CUDA kernel)
    keep both, as the XLA merge does; the Pallas merge3d kills one
    (ROADMAP.md Queue 3)."""
    d = random_gm3_np(np.random.default_rng(1), P=1, N=4, n_alive=2,
                      spread=0.01)
    d["w"][:] = 0.0
    out = gm_ops.merge(port_gm(d), 3.0, 1.0)
    ref = jgm.merge(jax_gm(d), 3.0, 1.0)
    assert_gm_close(out, ref)
    assert int(out.alive.sum()) == 2


def test_merge_dispatch_by_dimension(rng):
    d3 = port_gm(random_gm3_np(rng, P=2, N=8, n_alive=4))
    with pytest.raises(ValueError, match="D=3"):
        merge2d_mod.merge2d(d3, 1.5, 1.5)
    d2 = GMState(d3.mean[:2], d3.cov[[0, 1, 3]], d3.w, d3.w_prev, d3.alive)
    with pytest.raises(ValueError, match="D=2"):
        merge3d_mod.merge3d(d2, 1.5, 1.5)
    n2, n3 = merge2d_mod.launches, merge3d_mod.launches
    gm_ops.merge(d3, 1.5, 1.5)
    gm_ops.merge(d2, 1.5, 1.5)
    assert (merge2d_mod.launches, merge3d_mod.launches) == (n2, n3)
