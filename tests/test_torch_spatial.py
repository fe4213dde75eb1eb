"""rfs_slam_tpu_torch.ops.spatial against the JAX package's ops/spatial.py on
the same numpy inputs, in 2-D and 3-D: the index (order and bucket
offsets equal), box queries, and nearest-point queries with masked points,
equal-distance ties and a bucket fuller than ``bucket_cap`` (indices and
found flags equal, distances within 1e-6 relative)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rfs_slam_tpu.ops import spatial as js
from rfs_slam_tpu_torch.ops import spatial as ts
from tests.torch_parity import t


def both_indices(points, mask, origin, cell, res):
    ji = js.build(jnp.asarray(points), jnp.asarray(mask), origin, cell, res)
    ti = ts.build(t(points), t(mask), origin, cell, res)
    np.testing.assert_array_equal(ti.order.numpy(), np.asarray(ji.order))
    np.testing.assert_array_equal(ti.starts.numpy(), np.asarray(ji.starts))
    return ji, ti


def assert_nearest_equal(ji, ti, q, **kw):
    want = jax.vmap(lambda x: js.nearest(ji, x, **kw))(jnp.asarray(q))
    got = ts.nearest(ti, t(q), **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-6)
    return got


def cloud(seed, n, D, lo=0.0, hi=8.0, masked=0.15):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(lo, hi, size=(n, D)).astype(np.float32)
    return rng, pts, rng.random(n) >= masked


@pytest.mark.parametrize("D,res,seed", [(2, (8, 8), 0), (2, (5, 9), 1),
                                        (3, (4, 4, 4), 2),
                                        (3, (3, 5, 4), 3)])
def test_build_query_nearest_match_jax(D, res, seed):
    rng, pts, mask = cloud(seed, 150, D)
    # points outside the grid clip into its edge cells
    pts[:4] = [[-1.0] * D, [9.5] * D, [0.0] * D, [8.0] * D]
    ji, ti = both_indices(pts, mask, (0.0,) * D, 8.0 / min(res), res)

    for lo, hi in [((2.0,) * D, (5.0,) * D), ((-2.0,) * D, (1.0,) * D),
                   ((0.0,) * D, (8.0,) * D), ((6.0,) * D, (5.0,) * D)]:
        for k in (5, 150):
            want = js.query_box(ji, lo, hi, k)
            got = ts.query_box(ti, lo, hi, k)
            np.testing.assert_array_equal(got[0].numpy(),
                                          np.asarray(want[0]))
            np.testing.assert_array_equal(got[1].numpy(),
                                          np.asarray(want[1]))

    q = rng.uniform(-1.0, 9.0, size=(40, D)).astype(np.float32)
    for n_rings in (0, 1, 2):
        assert_nearest_equal(ji, ti, q, n_rings=n_rings)
    # the exact neighbour where every point lies within the rings
    idx, dist, found = ts.nearest(ti, t(q), n_rings=max(res))
    d = np.linalg.norm(pts[None] - q[:, None], axis=-1)
    d[:, ~mask] = np.inf
    np.testing.assert_allclose(dist.numpy(), d.min(axis=1), rtol=1e-5)
    assert found.all()


@pytest.mark.parametrize("D", [2, 3])
def test_nearest_equal_distance_ties(D):
    """Points at the same distance from the query in several cells: the
    first candidate in bucket order wins in both."""
    q = np.full((1, D), 4.0, np.float32)
    offs = np.eye(D, dtype=np.float32)
    pts = np.concatenate([q + offs, q - offs, q + 2 * offs]).astype(
        np.float32)
    mask = np.ones(len(pts), bool)
    ji, ti = both_indices(pts, mask, (0.0,) * D, 1.0, (8,) * D)
    idx, dist, _ = assert_nearest_equal(ji, ti, q)
    assert float(dist[0]) == 1.0
    mask[int(idx[0])] = False                   # the next of the tie
    ji, ti = both_indices(pts, mask, (0.0,) * D, 1.0, (8,) * D)
    assert_nearest_equal(ji, ti, q)


@pytest.mark.parametrize("D", [2, 3])
def test_overfull_bucket_drops_the_same_points(D):
    """Forty points in one cell with bucket_cap 8: only the first eight in
    bucket order are searched, in JAX as in the port, so the true nearest
    (placed last) is missed by both."""
    rng = np.random.default_rng(4)
    pts = (1.5 + 0.4 * rng.random((40, D))).astype(np.float32)
    q = np.full((1, D), 1.5, np.float32)
    pts[-1] = q[0] + 0.01
    mask = np.ones(40, bool)
    ji, ti = both_indices(pts, mask, (0.0,) * D, 1.0, (4,) * D)
    idx, _, found = assert_nearest_equal(ji, ti, q, bucket_cap=8)
    assert bool(found[0]) and int(idx[0]) != 39
    idx, _, _ = assert_nearest_equal(ji, ti, q, bucket_cap=64)
    assert int(idx[0]) == 39


def test_nearest_nothing_in_reach():
    pts = np.array([[7.5, 7.5]], np.float32)
    ji, ti = both_indices(pts, np.ones(1, bool), (0.0, 0.0), 1.0, (8, 8))
    idx, dist, found = assert_nearest_equal(
        ji, ti, np.array([[0.5, 0.5]], np.float32), n_rings=1)
    assert int(idx[0]) == -1 and not bool(found[0])
    assert np.isinf(float(dist[0]))
