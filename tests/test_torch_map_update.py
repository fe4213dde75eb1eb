"""The map_update2d twin against the JAX package's fused Pallas kernel
(interpret mode) and its XLA formulas, on a mid-run state, with the
tolerances of tests/test_map_update_fused.py."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rfs_slam_tpu.filters.rbphd import RBPHDFilter as JRBPHDFilter
from rfs_slam_tpu.ops.ekf import correct_all as jcorrect_all
from rfs_slam_tpu.ops.pallas.map_update2d import (fused_map_update2d as
                                                  jfused, pack_params as
                                                  jpack_params)
from rfs_slam_tpu_torch import convert
from rfs_slam_tpu_torch.apps import sim2d_common as loop
from rfs_slam_tpu_torch.filters.rbphd import RBPHDFilter
from rfs_slam_tpu_torch.io import sim2d
from rfs_slam_tpu_torch.ops.kernels import map_update2d as mu
from tests.test_rbphd_filter import build_filter
from tests.torch_parity import CPU, assert_gm_close, jax_state, t


@pytest.fixture(scope="module")
def midrun():
    """The port after 45 ground-truth-locked steps of a short simulation,
    predicted once more, with that step's measurements; and the JAX filter
    it was converted from."""
    sim_cfg = sim2d.Sim2DConfig(timesteps=60, n_landmarks=20, n_segments=4)
    data = sim2d.generate(sim_cfg, traj_seed=3, noise_seed=4, z_capacity=24)
    jfilt = build_filter(sim_cfg, n_particles=16)
    jfilt.cfg = dataclasses.replace(jfilt.cfg, map_capacity=128)
    filt = convert.filter_from_numpy(jfilt, CPU)
    gen = torch.Generator().manual_seed(1)
    state, _ = loop.run(filt, loop.sim_inputs(data, steps=46), gen,
                        sim_cfg.dt)
    state = filt.predict(state, t(data.odometry[46], torch.float32),
                         sim_cfg.dt, gen=gen)
    assert int(state.gm.alive.sum()) > 100
    return (jfilt, filt, state, t(data.z[46], torch.float32),
            t(data.z_mask[46]))


def planes(state):
    gm = state.gm
    return (state.particles.pose, gm.mean[0], gm.mean[1], gm.cov[0],
            gm.cov[1], gm.cov[2], gm.w, gm.w_prev, gm.alive)


def test_pack_params_matches_jax(midrun):
    jfilt, filt, *_ = midrun
    cfg = filt.cfg
    np.testing.assert_array_equal(
        np.float32(mu.pack_params(filt.meas, filt.gates,
                                  cfg.new_gaussian_md_threshold,
                                  cfg.birth_gaussian_weight)),
        np.asarray(jpack_params(jfilt.meas, jfilt.gates,
                                cfg.new_gaussian_md_threshold,
                                cfg.birth_gaussian_weight)))


def assert_twin_matches_pallas(args, z, z_mask, params, T):
    """The twin against the Pallas kernel (interpret mode) on the same
    numpy inputs, with tests/test_map_update_fused.py's tolerances; returns
    both results."""
    got = mu.map_update2d_plain(*(t(a) for a in args), t(z), t(z_mask),
                                params, T)
    want = jfused(*(jnp.asarray(a) for a in args), jnp.asarray(z),
                  jnp.asarray(z_mask), jnp.asarray(np.float32(params)),
                  new_per_z=T, interpret=True)
    for name, rtol, atol in (("pd", 1e-6, 1e-7), ("col_sum", 5e-5, 1e-7),
                             ("w", 5e-5, 1e-7), ("w_prev", 0, 0),
                             ("K", 1e-4, 1e-6), ("cov_upd", 1e-4, 1e-6),
                             ("z_exp", 1e-5, 1e-6), ("cand_w", 1e-5, 1e-8)):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=rtol, atol=atol, err_msg=name)
    np.testing.assert_array_equal(got.unused.numpy(),
                                  np.asarray(want.unused))
    nz = np.asarray(want.cand_w) > 0
    np.testing.assert_array_equal(got.cand_m.numpy()[nz],
                                  np.asarray(want.cand_m)[nz])
    return got, want


def test_twin_matches_pallas_kernel(midrun):
    jfilt, filt, state, z, z_mask = midrun
    cfg = filt.cfg
    params = mu.pack_params(filt.meas, filt.gates,
                            cfg.new_gaussian_md_threshold,
                            cfg.birth_gaussian_weight)
    _, want = assert_twin_matches_pallas(
        [a.numpy() for a in planes(state)], z.numpy(), z_mask.numpy(),
        params, cfg.new_per_z)
    assert (np.asarray(want.cand_w) > 0).sum() > 50


def edge_inputs(state, z, z_mask, case):
    """numpy kernel inputs for the cases the CUDA design hinges on, cut
    from the mid-run state (P=16, M=128, Zc=24)."""
    a = [x.numpy().copy() for x in planes(state)]
    z, zm = z.numpy().copy(), z_mask.numpy().copy()
    if case == "ties":
        # slots 64-127 repeat slots 0-63: equal table values in a column
        for x in a[1:]:
            x[:, 64:] = x[:, :64]
    elif case == "sparse":
        # three alive slots a particle and none in particle 0: columns
        # with fewer than T positive cells, and all-zero columns
        a[8][:, 3:] = False
        a[8][0] = False
    elif case == "M=100":
        a = a[:1] + [x[:, :100] for x in a[1:]]
    elif case == "Zc=1":
        k = int(np.flatnonzero(zm)[0])
        z, zm = z[k:k + 1], zm[k:k + 1]
    elif case == "negative weights":
        a[6][:, ::3] *= -1.0
    elif case == "crowded":
        # every slot a copy of an alive one: ties, many columns with more
        # than T positive cells
        alive = a[8]
        n = int(alive.sum(axis=1).min())
        first = np.argsort(~alive, axis=1, kind="stable")[:, :n]
        crowd = np.tile(first, (1, -(-128 // n)))[:, :128]
        a = a[:1] + [np.take_along_axis(x, crowd, axis=1) for x in a[1:]]
    return a, z, zm


@pytest.mark.parametrize("case", ["ties", "sparse", "M=100", "Zc=1", "T=1",
                                  "negative weights", "crowded"])
def test_twin_matches_pallas_kernel_edges(midrun, case):
    """Tied values (cand_m takes the lowest index first), columns with
    fewer than T positive cells, M not a multiple of 32, one measurement,
    columns with more than T positive cells, negative table entries, every
    slot alive."""
    _, filt, state, z, z_mask = midrun
    T = 1 if case == "T=1" else filt.cfg.new_per_z
    args, z, zm = edge_inputs(state, z, z_mask, case)
    _, want = assert_twin_matches_pallas(args, z, zm, filt._map_params, T)
    Zc = z.shape[0]
    cw = np.asarray(want.cand_w).reshape(-1, T, Zc)
    cm = np.asarray(want.cand_m).reshape(-1, T, Zc)
    if case == "ties":
        # a column's next pick has the same weight at a higher slot
        tie = (cw[:, 1:] == cw[:, :-1]) & (cw[:, 1:] > 0)
        assert tie.any()
        assert (cm[:, 1:][tie] == cm[:, :-1][tie] + 64).all()
    if case == "sparse":
        assert ((cw[:, 0] > 0) & (cw[:, -1] == 0)).any()
        assert (cw[0] == 0).all()
    if case == "crowded":
        assert (cw[:, -1] > 0).any()
    if case == "negative weights":
        # negative table entries pull a column sum below the clutter term
        assert (np.asarray(want.col_sum) < filt._map_params[4]).any()


def test_launch_plan_fits_every_size():
    """Every M up to SMALL_SLOTS with Zc <= 64 launches in the small form
    within Hopper's limits, and the bench shape holds its whole table at
    once (the large form's plans: tests/test_torch_large_map.py)."""
    for M in range(1, mu.SMALL_SLOTS + 1):
        for Zc in range(65):
            threads, smem, zb, form, ws = mu.launch_plan(200, M, Zc, 8)
            assert threads % 32 == 0 and 32 <= threads <= mu.MAX_THREADS
            assert smem <= 232_448 and (form, ws) == ("small", 0)
            assert 1 <= zb <= max(Zc, 1)
    assert mu.launch_plan(200, 128, 40, 8) == (512, 4 * (120 + 10 * 128 + 4
                                                         + 40 * 128), 40,
                                               "small", 0)


# 60,000 slots: one table column and the pick bits past shared memory
@pytest.mark.parametrize("P,M,Zc", [(200, 60_000, 40), (200, 0, 40),
                                    (0, 128, 40), (200, 128, 60_000)])
def test_launch_plan_rejects(P, M, Zc):
    with pytest.raises(ValueError):
        mu.launch_plan(P, M, Zc, 8)


def test_twin_matches_xla_formulas(midrun):
    """The twin against the JAX package's XLA map-update head, verbatim
    from tests/test_map_update_fused.py."""
    assert_twin_matches_xla(*midrun)


def assert_twin_matches_xla(jfilt, filt, state, z, z_mask):
    """The twin on ``state`` against the XLA head's formulas of
    tests/test_map_update_fused.py, with its tolerances."""
    cfg = filt.cfg
    js = jax_state(convert.to_numpy(state), jax.random.PRNGKey(0))
    gm, pose = js.gm, js.particles.pose
    meas, gates = jfilt.meas, jfilt.gates
    jz, jzm = jnp.asarray(z.numpy()), jnp.asarray(z_mask.numpy())
    pd_raw, close = meas.pd_p(pose[:, None, :], gm.mean, gm.cov)
    pd_raw = jnp.where(gm.alive, pd_raw, 0.0)
    close = close & gm.alive
    pd = jnp.where(close, 1.0, pd_raw)
    corr = jcorrect_all(meas, gates, pose, gm.mean, gm.cov, jz)
    cell = (gm.alive[:, None, :] & (pd[:, None, :] > 0.0)
            & jzm[None, :, None]
            & (corr.md2 <= cfg.new_gaussian_md_threshold ** 2)
            & (corr.likelihood > 0.0))
    w_tab = jnp.where(cell, pd[:, None, :] * gm.w[:, None, :]
                      * corr.likelihood, 0.0)
    col_sum = meas.clutter_intensity(jz) + jnp.sum(w_tab, axis=2)
    w_tab = jnp.where(jzm[None, :, None], w_tab / col_sum[:, :, None], 0.0)
    w_miss = (1.0 - pd) * gm.w
    delta = pd * gm.w - jnp.sum(w_tab, axis=1)
    comp = close & (gm.w > cfg.birth_gaussian_weight) & (delta > 0.0)
    w_miss = jnp.where(comp, jnp.minimum(w_miss + delta, 1.0), w_miss)
    unused = jzm[None, :] & ~jnp.any(w_tab > 0.0, axis=2)

    got = mu.map_update2d_plain(*planes(state), z, z_mask, filt._map_params,
                                cfg.new_per_z)
    np.testing.assert_allclose(got.pd.numpy(), np.asarray(pd), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(got.col_sum.numpy(), np.asarray(col_sum),
                               rtol=5e-5, atol=1e-7)
    np.testing.assert_allclose(got.w.numpy(),
                               np.asarray(jnp.where(gm.alive, w_miss, gm.w)),
                               rtol=5e-5, atol=1e-7)
    np.testing.assert_array_equal(got.unused.numpy(), np.asarray(unused))
    for name in ("K", "cov_upd", "z_exp"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(corr, name)),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_wrapper_runs_twin_on_cpu(midrun):
    """For CPU tensors the wrapper is the twin and launches nothing."""
    _, filt, state, z, z_mask = midrun
    before = mu.launches
    got = mu.fused_map_update2d(*planes(state), z, z_mask, filt._map_params)
    want = mu.map_update2d_plain(*planes(state), z, z_mask, filt._map_params)
    assert mu.launches == before
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("cluster", [False, True])
def test_map_update_phase_matches_jax(midrun, cluster):
    """filters/rbphd.py:_map_update end to end (head, exact top-k, m + K nu
    at the selected cells, replace_weakest) against the JAX XLA path."""
    jfilt, filt, state, z, z_mask = midrun
    jcfg = dataclasses.replace(jfilt.cfg, fused_map_update="off",
                               use_cluster_process=cluster)
    jf = JRBPHDFilter(jfilt.motion, jfilt.lmk, jfilt.meas, jfilt.gates, jcfg)
    pf = RBPHDFilter(filt.motion, filt.lmk, filt.meas, filt.gates,
                     dataclasses.replace(filt.cfg,
                                         use_cluster_process=cluster))
    js = jax_state(convert.to_numpy(state), jax.random.PRNGKey(0))
    gm_x, lw_x, un_x, fov_x, cz_x = jf._map_update(
        js, jnp.asarray(z.numpy()), jnp.asarray(z_mask.numpy()), jfilt.meas)
    gm_p, lw_p, un_p, fov_p, cz_p = pf._map_update(state, z, z_mask)
    assert_gm_close(gm_p, gm_x)
    np.testing.assert_allclose(lw_p.numpy(), np.asarray(lw_x), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(un_p.numpy(), np.asarray(un_x))
    np.testing.assert_array_equal(fov_p.numpy(), np.asarray(fov_x))
    np.testing.assert_allclose(cz_p.numpy(), np.asarray(cz_x))


@pytest.mark.parametrize("case", [None, "ties", "sparse", "crowded",
                                  "negative weights"])
@pytest.mark.parametrize("blocks", [1, 2, 4])
def test_block_form_matches_one_launch(midrun, blocks, case):
    """The block form's twin (each block's head and tail, the column sums
    combined in block order, the picks merged) over 1, 2 and 4 blocks of
    the slot axis against the one-launch twin: the unused flags and the
    picks equal, every float equal over one block and within the
    kernel-against-twin tolerances over more (a crowded column's sum adds
    in another order); launches nothing on CPU tensors."""
    _, filt, state, z, z_mask = midrun
    args = planes(state)
    if case is not None:
        a, z, z_mask = edge_inputs(state, z, z_mask, case)
        args, z, z_mask = ([torch.from_numpy(x) for x in a],
                           torch.from_numpy(z), torch.from_numpy(z_mask))
    before = mu.launches
    want = mu.map_update2d_plain(*args, z, z_mask, filt._map_params)
    got = mu.map_update2d_blocks(*args, z, z_mask, filt._map_params,
                                 n_blocks=blocks)
    assert mu.launches == before
    for name in ("unused", "cand_m"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(want, name).numpy(),
                                      err_msg=name)
    for name, rtol, atol in (("pd", 0, 0), ("w_prev", 0, 0), ("K", 0, 0),
                             ("cov_upd", 0, 0), ("z_exp", 0, 0),
                             ("col_sum", 5e-5, 1e-7), ("w", 5e-5, 1e-7),
                             ("cand_w", 1e-5, 1e-8)):
        g, w = getattr(got, name).numpy(), getattr(want, name).numpy()
        if blocks == 1:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                       err_msg=name)


def test_block_form_picks_merge_by_the_kernel_rule():
    """``merge_block_picks`` on two blocks of one column (T=3): value
    descending, the lower slot first among equals across blocks, zeros
    (a column with fewer positives) at the lowest slot; the column is
    unused only where every block says so."""
    cw = torch.tensor([[[0.5, 0.2, 0.0]], [[0.5, 0.3, 0.0]]])
    cm = torch.tensor([[[7, 2, 0]], [[9, 12, 8]]])
    un = torch.tensor([[[False]], [[True]]])
    w, m, u = mu.merge_block_picks(cw, cm, un, 3)
    assert torch.equal(w, torch.tensor([[0.5, 0.5, 0.3]]))
    assert m.tolist() == [[7, 9, 12]]
    assert u.tolist() == [[False]]
    w, m, _ = mu.merge_block_picks(torch.tensor([[[0.4, 0.0, 0.0]],
                                                 [[0.0, 0.0, 0.0]]]),
                                   torch.tensor([[[3, 0, 0]], [[8, 8, 8]]]),
                                   un, 3)
    assert torch.equal(w, torch.tensor([[0.4, 0.0, 0.0]]))
    assert m.tolist() == [[3, 0, 0]]


def test_block_launch_plan_fits_every_block():
    """A block of M / B slots of every map up to 8,192 slots (B = 1, 2, 4,
    8 where it divides M) meets the launch plan's limits, in the small
    form up to SMALL_SLOTS slots a block and in the large form above."""
    for M in range(8, 8192 + 1, 8):
        for B in (1, 2, 4, 8):
            plan = mu.launch_plan(200, M // B, 40, 8)
            assert 32 <= plan.threads <= mu.MAX_THREADS
            assert plan.smem <= 232_448
            assert plan.form == ("small" if M // B <= mu.SMALL_SLOTS
                                 else "large")
