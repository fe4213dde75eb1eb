"""rfs_slam_tpu_torch.ops.jcbb against the JAX package's ops/jcbb.py on the
same numpy inputs: the dense search against JAX and the exhaustive oracle
of tests/test_jcbb.py, the block-diagonal search against JAX's (which
builds the dense S) with masks, the tie order, the chi-square quantile, and
the block-diagonal search's allocations at Victoria Park's width.

Tolerances: assoc and n_paired equal; md2 within 1e-5 relative (the
search's floats are JAX's operations, summed in another order by einsum);
the quantile within 1e-6 relative (erfinv in float32)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rfs_slam_tpu.ops import jcbb as jj
from rfs_slam_tpu_torch.ops import jcbb as tj
from tests.test_jcbb import build_problem, oracle
from tests.torch_parity import t


def both(fn_j, fn_t, *arrays, **kw):
    """The JAX and the port's results of one call on the same numpy
    arrays, as numpy."""
    out_j = fn_j(*(jnp.asarray(a) for a in arrays), **kw)
    out_t = fn_t(*(t(a) for a in arrays), **kw)
    return ([np.asarray(x) for x in out_j],
            [x.numpy() for x in out_t])


def assert_same(got_j, got_t):
    np.testing.assert_array_equal(got_t[0], got_j[0])
    assert int(got_t[1]) == int(got_j[1])
    np.testing.assert_allclose(got_t[2], got_j[2], rtol=1e-5, atol=1e-7)


def block_problem(seed, Z, M, D, n_zoff=1, n_moff=2):
    """Innovations either near (sd 0.3) or far (sd 8) from each landmark,
    landmark covariances A A^T + 0.5 I, some measurements and landmarks
    masked off: cumulative md2 stays far from the gates."""
    rng = np.random.default_rng(seed)
    near = rng.random((Z, M)) < 0.35
    innov = (rng.normal(size=(Z, M, D))
             * np.where(near, 0.3, 8.0)[..., None]).astype(np.float32)
    A = rng.normal(size=(M, D, D)) * 0.4
    S = (A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(D)).astype(np.float32)
    z_mask = np.ones(Z, bool)
    z_mask[rng.choice(Z, n_zoff, replace=False)] = False
    m_mask = np.ones(M, bool)
    m_mask[rng.choice(M, n_moff, replace=False)] = False
    return innov, S, z_mask, m_mask


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("correlated", [False, True])
def test_jcbb_dense_matches_jax_and_oracle(seed, correlated):
    rng = np.random.default_rng(seed)
    Z, M, D = 3, 4, 2
    innov, S = build_problem(rng, Z, M, D, correlated)
    innov, S = innov.astype(np.float32), S.astype(np.float32)
    got_j, got_t = both(jj.jcbb, tj.jcbb, innov, S, np.ones(Z, bool),
                        np.ones(M, bool), confidence=0.95, beam=160)
    assert_same(got_j, got_t)
    n_ref, md2_ref, assoc_ref = oracle(innov.astype(np.float64),
                                       S.astype(np.float64))
    assert int(got_t[1]) == n_ref
    np.testing.assert_allclose(float(got_t[2]), md2_ref, rtol=2e-3,
                               atol=1e-4)
    np.testing.assert_array_equal(got_t[0], assoc_ref)


@pytest.mark.parametrize("Z,M,D,seed", [(5, 8, 2, 0), (5, 8, 2, 1),
                                        (5, 8, 2, 2), (4, 6, 3, 0),
                                        (4, 6, 3, 1), (4, 6, 3, 2)])
@pytest.mark.parametrize("beam", [4, 32])
def test_jcbb_block_diag_matches_jax(Z, M, D, seed, beam):
    innov, S, z_mask, m_mask = block_problem(seed, Z, M, D)
    got_j, got_t = both(jj.jcbb_block_diag, tj.jcbb_block_diag, innov, S,
                        z_mask, m_mask, confidence=0.95, beam=beam)
    assert_same(got_j, got_t)
    assert int(got_t[1]) >= 1
    assert (got_t[0][~z_mask] == -1).all()
    assert not np.isin(got_t[0], np.flatnonzero(~m_mask)).any()


@pytest.mark.parametrize("Z,M,D,seed", [(5, 8, 2, 3), (4, 6, 3, 4)])
def test_jcbb_block_diag_equals_dense_port(Z, M, D, seed):
    """The block-diagonal search gives the dense search's answer on the
    dense S it stands for (every gathered cross block zero)."""
    innov, S_diag, z_mask, m_mask = block_problem(seed, Z, M, D)
    S = np.zeros((Z, M, Z, M, D, D), np.float32)
    for z in range(Z):
        for m in range(M):
            S[z, m, z, m] = S_diag[m]
    a = tj.jcbb_block_diag(t(innov), t(S_diag), t(z_mask), t(m_mask))
    b = tj.jcbb(t(innov), t(S), t(z_mask), t(m_mask))
    np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
    assert int(a[1]) == int(b[1])
    np.testing.assert_allclose(float(a[2]), float(b[2]), rtol=1e-6)


@pytest.mark.parametrize("Z,M,D,want", [
    (4, 5, 2, [0, 1, 2, 3]), (3, 3, 3, [0, 1, 2]),
    # more measurements than landmarks: the beam's order decides which
    # full-cardinality hypothesis comes first
    (5, 3, 2, [-1, 0, 1, 2, -1])])
def test_jcbb_tie_order(Z, M, D, want):
    """Every pairing scores the same: the survivors are the lower flat
    indices, so measurement z takes the lowest free landmark."""
    innov = np.zeros((Z, M, D), np.float32)
    S = np.broadcast_to(np.eye(D, dtype=np.float32), (M, D, D)).copy()
    got_j, got_t = both(jj.jcbb_block_diag, tj.jcbb_block_diag, innov, S,
                        np.ones(Z, bool), np.ones(M, bool), beam=8)
    assert_same(got_j, got_t)
    np.testing.assert_array_equal(got_t[0], want)


def test_jcbb_groups_of_equal_scores():
    """Two landmarks with equal innovations against every measurement: the
    tie between them goes to the lower index, in JAX and in the port."""
    Z, M, D = 4, 6, 2
    rng = np.random.default_rng(7)
    innov = (rng.normal(size=(Z, M, D)) * 0.3).astype(np.float32)
    innov[:, 3] = innov[:, 1]
    S = np.broadcast_to(np.eye(D, dtype=np.float32), (M, D, D)).copy()
    for beam in (2, 6, 32):
        got_j, got_t = both(jj.jcbb_block_diag, tj.jcbb_block_diag, innov,
                            S, np.ones(Z, bool), np.ones(M, bool), beam=beam)
        assert_same(got_j, got_t)


@pytest.mark.parametrize("p", [0.9, 0.95, 0.99])
def test_chi2_quantile_matches_jax(p):
    df = np.arange(1, 73, dtype=np.float32)
    np.testing.assert_allclose(tj.chi2_quantile(p, t(df)).numpy(),
                               np.asarray(jj.chi2_quantile(p, df)),
                               rtol=1e-6)
    assert abs(float(tj.chi2_quantile(0.95, 2)) - 5.991) < 0.15


def largest_allocation(fn):
    """The bytes of the largest single CPU allocation made by ``fn()``."""
    with profile(activities=[ProfilerActivity.CPU], profile_memory=True,
                 record_shapes=True, with_stack=True) as prof:
        fn()
    created = [n for _, action, _, n in prof._memory_profile().timeline
               if action.name == "CREATE"]
    return max(created)


def test_block_diag_allocations_at_vp_width():
    """Z=24, M=512, D=3, beam 32 (the Victoria Park FastSLAM width): the
    JAX form's dense S would be 5.4 GB; no allocation of the search
    exceeds 16 MiB."""
    assert largest_allocation(lambda: torch.empty(5 * 2**20)) == 20 * 2**20
    Z, M, D = 24, 512, 3
    innov, S, z_mask, m_mask = block_problem(5, Z, M, D, n_zoff=3,
                                             n_moff=40)
    args = (t(innov), t(S), t(z_mask), t(m_mask))
    out = []
    big = largest_allocation(
        lambda: out.append(tj.jcbb_block_diag(*args, beam=32)))
    assert big <= 16 * 2**20, big
    assoc, n, md2 = out[0]
    assert int(n) == int((assoc >= 0).sum()) and int(n) >= 1
    assert np.isfinite(float(md2))
