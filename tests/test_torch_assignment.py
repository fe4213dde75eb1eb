"""The port's assignment ops against the JAX package's on the same numpy
inputs: the Hungarian twin (row_to_col equal, u / v / total within rtol
1e-6), Murty with every option, the gated Murty, the dual bound, and the
small combinatorics.  Discrete outputs must be equal."""

import itertools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rfs_slam_tpu.ops import assignment as ja
from rfs_slam_tpu_torch.ops import assignment as pa
from rfs_slam_tpu_torch.ops.kernels import hungarian as hk
from tests.torch_parity import t

RTOL = 1e-6


def hungarian_cases(rng, n, B=12):
    """Random batches with the inputs the search's exits hinge on: an
    all-equal matrix (ties), a row and a column wholly NEG, a real block
    over a floor (the DA table's padding), integer costs (ties in sums)."""
    c = (rng.normal(size=(B, n, n)) * 3).astype(np.float32)
    c[0] = 1.0
    c[1, n // 2, :] = ja.NEG
    c[2, :, n - 1] = ja.NEG
    c[3] = -10.0
    m = max(1, n // 2)
    c[3, :m, :m] = rng.normal(size=(m, m)) * 2
    c[4] = rng.integers(-2, 3, size=(n, n))
    return c


def assert_hungarian_equal(got, want):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w, name in zip(got[1:], want[1:], ("total", "u", "v")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=0, err_msg=name)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 12])
def test_hungarian_uv_plain_matches_jax(rng, n):
    c = hungarian_cases(rng, n)
    want = jax.vmap(ja._hungarian_uv)(jnp.asarray(c))
    assert_hungarian_equal(pa.hungarian_uv_plain(t(c)), want)


def test_hungarian_dispatches_to_the_twin_on_cpu(rng):
    """CPU tensors run the twin (no launch counted); single matrices and
    batches give the same answers, and the trips are counted per lane."""
    c = hungarian_cases(rng, 6)
    before = hk.launches
    sol, total = pa.hungarian(t(c))
    sol1, total1 = pa.hungarian(t(c[5]))
    assert hk.launches == before
    want = jax.vmap(ja.hungarian)(jnp.asarray(c))
    np.testing.assert_array_equal(sol.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(sol1.numpy(), np.asarray(want[0])[5])
    np.testing.assert_allclose(total1.item(), float(want[1][5]), rtol=RTOL)
    *_, trips, used = pa.hungarian_uv_plain(t(c), return_trips=True)
    assert trips.shape == (12,) and bool((trips >= 6).all())
    assert bool((trips <= 6 * 8).all())
    # every trip has column 0 and at most all 7 columns used
    assert bool((used >= trips).all()) and bool((used <= 7 * trips).all())


def test_hungarian_empty_batch_on_cpu():
    sol, total, u, v = pa._hungarian_uv(torch.zeros(0, 4, 4))
    assert sol.shape == (0, 4) and u.shape == (0, 5)


# ---- a numpy model of the CUDA kernel's search (csrc/hungarian.cu): one
# warp of 32 lanes, lane l owning columns and rows 1 + l + 32 k (k < K) in
# [K, 32] arrays; the row counts from the visited i0; the argmin by
# order-preserving keys with the lowest k, then the lowest lane, on ties;
# u += delta * count.  The kernel runs only on the card; this holds its
# algorithm to the twin and to JAX here.

F32 = np.float32
NO_KEY = np.uint32(0xFFFFFFFF)


def order_keys(x):
    """Order-preserving uint32 keys of f32 ``x``, -0.0 folded onto +0.0 by
    adding +0.0."""
    b = (np.asarray(x, F32) + F32(0)).view(np.uint32)
    return np.where(b & np.uint32(0x80000000), ~b, b | np.uint32(0x80000000))


def warp_hungarian(c):
    """The kernel's search on one matrix ``c [n, n]`` (f32):
    ``(row_to_col, total, u, v)``."""
    n = c.shape[0]
    K = hk.launch_plan(1, n).k
    INF = F32(np.finfo(np.float32).max / 8)
    inf_key = order_keys(np.array([INF]))[0]
    col = 1 + np.arange(32)[None, :] + 32 * np.arange(K)[:, None]  # [K, 32]
    valid = col <= n
    a = np.zeros((K, 32, n), F32)       # a[k, l] = -c[:, col - 1]: by row
    a[valid] = -c.T[col[valid] - 1]
    slot = lambda j: ((j - 1) // 32, (j - 1) % 32)  # noqa: E731
    u, v = np.zeros((K, 32), F32), np.zeros((K, 32), F32)
    p = np.zeros((K, 32), np.int64)
    u0, v0 = F32(0), F32(0)
    for i in range(n):
        minv = np.full((K, 32), INF, F32)
        way = np.zeros((K, 32), np.int64)
        cnt = np.zeros((K, 32), np.int64)
        used = np.zeros((K, 32), bool)
        p0 = i + 1
        j0, i0, it = 0, p0, 0
        while i0 != 0 and it <= n + 1:
            if j0 != 0:
                used[slot(j0)] = True
            if it == 0 or j0 != 0:        # a trip that marked a new column
                cnt[slot(i0)] += 1
            ui0 = u[slot(i0)]
            open_ = valid & ~used
            cur = (a[:, :, i0 - 1] - ui0) - v
            better = open_ & (cur < minv)
            minv = np.where(better, cur, minv)
            way = np.where(better, j0, way)
            best, bk = np.zeros(32, F32), np.full(32, K)
            for k in range(K):              # each lane's first minimum
                take = open_[k] & ((bk == K) | (minv[k] < best))
                best = np.where(take, minv[k], best)
                bk = np.where(take, k, bk)
            # no open column: the kernel's NaN, whose key is the largest
            key = np.where(bk < K, order_keys(best), NO_KEY)
            kmin = key.min()
            wk = bk[key == kmin].min()
            wl = int(np.flatnonzero((key == kmin) & (bk == wk))[0])
            if kmin >= inf_key:             # column 0 (used, INF) wins
                delta, j1 = INF, 0
            else:
                delta, j1 = best[wl], 1 + wl + 32 * int(wk)
            u0 = u0 + delta * F32(0)
            u = u + delta * cnt.astype(F32)
            v0 = v0 - delta
            v = np.where(used, v - delta, v)
            minv = np.where(used, minv, minv - delta)
            j0, i0, it = j1, (p0 if j1 == 0 else int(p[slot(j1)])), it + 1
        it = 0
        while j0 != 0 and it <= n + 1:
            j1 = int(way[slot(j0)])
            p[slot(j0)] = p0 if j1 == 0 else p[slot(j1)]
            j0, it = j1, it + 1
    r2c = np.zeros(n, np.int64)
    for k, lane in zip(*np.nonzero(valid & (p != 0))):
        r = p[k, lane] - 1
        r2c[r] = max(r2c[r], col[k, lane] - 1)
    total = F32(0)
    for r in range(n):
        total = total + c[r, r2c[r]]
    return (r2c, total, np.concatenate([[u0], u.reshape(-1)[:n]]),
            np.concatenate([[v0], v.reshape(-1)[:n]]))


def beyond_inf(rng, n, B=4):
    """Rows and columns of -3e38, below -INF: every unused minv stays at
    INF, column 0 wins the argmin (delta = INF), and the next trip revisits
    it without marking a new column; the potentials overflow."""
    c = (rng.normal(size=(B, n, n)) * 3).astype(F32)
    c[0, 1, :] = -3e38
    c[1] = -3e38
    c[2, :, 0] = -3e38
    c[3, 0, :2] = -3e38
    return c


def signed_zero_ties(rng, n, B=6):
    """Each row's maximum a 0.0 or -0.0 at several columns, tied under <."""
    c = -np.abs(rng.normal(size=(B, n, n))).astype(F32) - F32(0.5)
    hits = rng.random((B, n, n)) < 0.2
    c[hits] = np.where(rng.random(hits.sum()) < 0.5, F32(0.0), F32(-0.0))
    return c


def bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 52, 64, "signed zeros",
                               "beyond INF"])
def test_warp_search_model_equals_twin_and_jax_to_the_bit(rng, n):
    """The kernel's search, modelled, gives the twin's four outputs to the
    bit, and JAX's row_to_col, u and v to the bit."""
    c = (signed_zero_ties(rng, 32) if n == "signed zeros"
         else beyond_inf(rng, 33) if n == "beyond INF"
         else hungarian_cases(rng, n, B=6 if n > 32 else 12))
    twin = pa.hungarian_uv_plain(t(c))
    want = jax.vmap(ja._hungarian_uv)(jnp.asarray(c))
    with np.errstate(over="ignore", invalid="ignore"):
        got = [warp_hungarian(m) for m in c]
    for f, name in enumerate(("row_to_col", "total", "u", "v")):
        g = np.stack([np.asarray(x[f]) for x in got])
        if f == 0:
            np.testing.assert_array_equal(g, twin[0].numpy(), err_msg=name)
            np.testing.assert_array_equal(g, np.asarray(want[0]),
                                          err_msg=name)
            continue
        np.testing.assert_array_equal(bits(g), bits(twin[f].numpy()),
                                      err_msg=name)
        if name == "total":   # jnp.sum adds in XLA's order, not row by row
            np.testing.assert_allclose(g, np.asarray(want[f]), rtol=RTOL,
                                       atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(bits(g), bits(want[f]),
                                          err_msg=name)


def assert_murty_equal(got, want):
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-5)
        else:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n,k,cap,window", [
    (3, 4, None, None), (4, 6, 3, None), (5, 8, 4, 3.0), (6, 5, 2, 3.0),
    (2, 4, None, None)])
def test_murty_matches_jax(rng, n, k, cap, window):
    """Uncapped, capped (the stable dual-bound order), capped with the
    prune window, and exhaustion (2 x 2 has two assignments)."""
    for _ in range(3):
        c = (rng.normal(size=(n, n)) * 2).astype(np.float32)
        want = ja.murty(jnp.asarray(c), k, child_cap=cap,
                        prune_window=window, return_nvalid=True)
        assert_murty_equal(pa.murty(t(c), k, child_cap=cap,
                                    prune_window=window, return_nvalid=True),
                           want)


@pytest.mark.parametrize("traced", [False, True])
def test_murty_real_block_matches_jax(rng, traced):
    """The real-assignment block on a floor-padded table, as static ints
    and as per-lane values (tensors here, traced values in JAX), batched."""
    n, nR, nC, k = 5, 3, 2, 6
    c = np.full((4, n, n), -20.0, np.float32)
    c[:, :nR, :nC] = rng.normal(size=(4, nR, nC)) * 2
    if traced:
        want = jax.jit(jax.vmap(
            lambda x, r: ja.murty(x, k, real_rows=r, real_cols=jnp.int32(nC),
                                  child_cap=2, prune_window=6.0)))(
            jnp.asarray(c), jnp.full((4,), nR, jnp.int32))
        got = pa.murty(t(c), k, real_rows=torch.full((4,), nR),
                       real_cols=torch.tensor(nC), child_cap=2,
                       prune_window=6.0)
    else:
        want = jax.vmap(lambda x: ja.murty(x, k, real_rows=nR,
                                           real_cols=nC))(jnp.asarray(c))
        got = pa.murty(t(c), k, real_rows=nR, real_cols=nC)
    assert_murty_equal(got, want)


def mh_tables(rng, P, n, floor=-20.0):
    """tests/test_assignment.py's MH-style DA tables."""
    tables = np.full((P, n, n), floor, np.float32)
    n_ms = rng.integers(0, n, size=P).astype(np.int32)
    n_z = int(rng.integers(1, n))
    for p in range(P):
        tables[p, :n_ms[p], :n_z] = rng.normal(size=(n_ms[p], n_z)) * 2
    return tables, n_ms, n_z


@pytest.mark.parametrize("budget,window", [(None, 3.0), (11, 3.0), (2, 6.0)])
def test_murty_gated_matches_jax(rng, budget, window):
    P, n, k = 12, 6, 3
    for _ in range(2 if budget == 2 else 1):
        tables, n_ms, n_z = mh_tables(rng, P, n)
        want = ja.murty_gated(jnp.asarray(tables), k, jnp.asarray(n_ms),
                              real_cols=n_z, child_cap=4,
                              prune_window=window, budget=budget,
                              return_overflow=True)
        got = pa.murty_gated(t(tables), k, t(n_ms).long(), real_cols=n_z,
                             child_cap=4, prune_window=window, budget=budget,
                             return_overflow=True)
        assert_murty_equal(got[:3], want[:3])
        assert int(got[3]) == int(want[3])


def test_second_best_bound_and_ambiguous_lanes_match_jax(rng):
    P, n = 12, 6
    tables, n_ms, n_z = mh_tables(rng, P, n)
    sols, tots, us, vs = jax.vmap(ja._hungarian_uv)(jnp.asarray(tables))
    want = jax.vmap(lambda c, s, tt, u, v, nr: ja.second_best_bound(
        c, s, tt, u, v, nr, n_z))(jnp.asarray(tables), sols, tots, us, vs,
                                  jnp.asarray(n_ms))
    got = pa.second_best_bound(t(tables), t(sols).long(), t(tots), t(us),
                               t(vs), t(n_ms).long(), n_z)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    np.testing.assert_array_equal(
        pa.ambiguous_lanes(t(tables), t(n_ms).long(), n_z, 3.0).numpy(),
        np.asarray(ja.ambiguous_lanes(jnp.asarray(tables), jnp.asarray(n_ms),
                                      n_z, 3.0)))


def test_cost_partition_matches_jax(rng):
    gates = rng.random((3, 12, 9)) < 0.15
    gates[0] = False
    for g in gates:
        want = ja.cost_partition(jnp.asarray(g))
        got = pa.cost_partition(t(g))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = pa.cost_partition(t(gates))        # batched
    np.testing.assert_array_equal(
        got[0][1].numpy(), np.asarray(ja.cost_partition(
            jnp.asarray(gates[1]))[0]))


@pytest.mark.parametrize("case", ["unique", "one left", "random"])
def test_cost_reduce_matches_jax(rng, case):
    cost = {"unique": np.array([[0, 0, 9], [8, 7, 0], [6, 4, 0]], np.float32),
            "one left": np.array([[9, 0], [0, 0.5]], np.float32),
            "random": (rng.random((7, 7)) * (rng.random((7, 7)) < 0.25)
                       * 4).astype(np.float32)}[case]
    want = ja.cost_reduce(jnp.asarray(cost), 1.0)
    got = pa.cost_reduce(t(cost), 1.0)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_matrix_permanent_matches_jax(rng):
    """Integer matrices: exact, as in JAX.  Random [0, 1) matrices: the
    Ryser sum cancels in float32, and the JAX function itself reads up to
    2e-5 off the float64 permanent at n=6, so both are held to it within
    rtol 5e-5."""
    for n in (2, 4, 6):
        a = rng.integers(0, 3, size=(n, n)).astype(np.float32)
        assert pa.matrix_permanent(t(a)).item() == float(
            ja.matrix_permanent(jnp.asarray(a)))
        a = rng.random((n, n)).astype(np.float32)
        exact = sum(np.prod([float(a[i, p[i]]) for i in range(n)])
                    for p in itertools.permutations(range(n)))
        for got in (pa.matrix_permanent(t(a)).item(),
                    float(ja.matrix_permanent(jnp.asarray(a)))):
            np.testing.assert_allclose(got, exact, rtol=5e-5)
    assert pa.matrix_permanent(torch.ones(5, 5)).item() == 120.0


def test_numpy_oracles_equal_jax(rng):
    c = rng.normal(size=(4, 4)).astype(np.float32)
    for a, b in zip(pa.brute_force_assignments(c, k=5),
                    ja.brute_force_assignments(c, k=5)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pa.permutations_lexicographic(3, 2),
                                  ja.permutations_lexicographic(3, 2))
    assert pa.NEG == ja.NEG
