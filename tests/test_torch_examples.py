"""The port's five examples (rfs_slam_tpu_torch/examples) on the CPU against
the JAX package's, same arguments and seeds: each validates itself as its
JAX twin does, and returns what the twin returns (discrete results equal;
float32 scores within 1e-6 relative, the float64 likelihood sum within
1e-12, OSPA terms within 1e-5)."""

import numpy as np
import pytest

from rfs_slam_tpu.examples import (
    linear_assignment_lexicographic as j_lex,
    linear_assignment_murty as j_murty,
    linear_assignment_partition as j_part,
    ospa_error as j_ospa,
    spatial_index as j_spatial,
)
from rfs_slam_tpu_torch.examples import (
    linear_assignment_lexicographic as t_lex,
    linear_assignment_murty as t_murty,
    linear_assignment_partition as t_part,
    ospa_error as t_ospa,
    spatial_index as t_spatial,
)


@pytest.mark.parametrize("kw", [{}, dict(n_meas=2, n_lmk=3, k=8, seed=4)])
def test_murty_example(kw):
    got = t_murty.main(verbose=False, device="cpu", **kw)
    want = j_murty.main(verbose=False, **kw)
    assert len(got) == len(want) > 1
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got == sorted(got, reverse=True)


@pytest.mark.parametrize("seed", [2, 5])
def test_partition_example(seed):
    got = t_part.main(verbose=False, device="cpu", seed=seed)
    want = j_part.main(verbose=False, seed=seed)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6)
    assert got[2] > 0.0


@pytest.mark.parametrize("n_m,n_z", [(3, 2), (2, 4)])
def test_lexicographic_example(n_m, n_z):
    perms, total = t_lex.main(n_m, n_z, verbose=False, device="cpu")
    want_perms, want_total = j_lex.main(n_m, n_z, verbose=False)
    np.testing.assert_array_equal(perms, want_perms)
    np.testing.assert_allclose(total, want_total, rtol=1e-12)


def test_ospa_example():
    for got, want in zip(t_ospa.main(verbose=False, device="cpu"),
                         j_ospa.main(verbose=False), strict=True):
        for g, w in zip(got, want, strict=True):
            np.testing.assert_allclose(float(g), float(w), rtol=1e-5,
                                       atol=1e-6)


def test_spatial_index_example(tmp_path):
    got = t_spatial.main(out_file=str(tmp_path / "t.txt"), verbose=False,
                         device="cpu")
    want = j_spatial.main(out_file=str(tmp_path / "j.txt"), verbose=False)
    np.testing.assert_array_equal(got, want)
    assert got.sum() == 200
    assert ((tmp_path / "t.txt").read_bytes()
            == (tmp_path / "j.txt").read_bytes())
