"""The roofline arithmetic against hand counts at small shapes."""

import pytest
import torch

from portbench import bounds
from portbench.reference import map_update2d as twin
from portbench.reference.state import GMState

B, F = bounds.PEAK_BYTES_PER_S, bounds.PEAK_F32_FLOP_PER_S


def test_bound_takes_the_larger():
    assert bounds.bound(3_350, 0) == (pytest.approx(1e-9), "bytes")
    assert bounds.bound(0, 67_000) == (pytest.approx(1e-9), "operations")


def test_merge_bound_by_hand():
    """Three slots, 0 and 1 within the gate, 2 far: pass 1 inverts 3
    covariances, makes 4 gate tests (slot 1: its partner and the safe slot
    up to its claim; slot 2: the two alive slots below it) and merges one
    pair; pass 2 inverts 2 and tests 1, merging nothing: 3*7 + 4*15 + 30 +
    2*7 + 15 = 140 FLOP.  Bytes: every plane in and out, 2 * 87."""
    gm = GMState(mean=torch.tensor([[[0.0, 0.1, 50.0]], [[0.0, 0.0, 0.0]]]),
                 cov=torch.tensor([[[1.0, 1.0, 1.0]], [[0.0, 0.0, 0.0]],
                                   [[1.0, 1.0, 1.0]]]),
                 w=torch.tensor([[0.5, 0.4, 0.3]]),
                 w_prev=torch.zeros(1, 3),
                 alive=torch.ones(1, 3, dtype=torch.bool))
    assert bounds.merge_work(gm, 0.5, 1.5) == (174, 140.0)
    assert bounds.merge_bound(gm, 0.5, 1.5) == (pytest.approx(174 / B),
                                                "bytes")


def test_map_update_bound_by_hand():
    """One particle, two alive slots 1 m ahead (in range, Pd > 0), one
    valid measurement of two: 2 * 60 + 1 * 2 * (27 + 2T) FLOP; bytes from
    the shapes of the head's inputs and outputs."""
    P, M, Zc, T = 1, 2, 2, 3
    pose = torch.zeros(P, 3)
    mx, my = torch.tensor([[1.0, 1.2]]), torch.tensor([[0.0, 0.1]])
    c00 = c11 = torch.full((P, M), 0.01)
    c01 = torch.zeros(P, M)
    w, w_prev = torch.full((P, M), 0.5), torch.zeros(P, M)
    alive = torch.ones(P, M, dtype=torch.bool)
    z = torch.tensor([[1.0, 0.0], [0.0, 0.0]])
    z_mask = torch.tensor([True, False])
    params = (2.5, 0.5, 0.05, 0.99, 1e-4, 0.005, 0.0, 0.0005, 9.0, 0.01,
              1.0, 0.2)
    args = (pose, mx, my, c00, c01, c11, w, w_prev, alive, z, z_mask,
            params)
    out = twin.map_update2d_plain(*args, new_per_z=T)
    in_bytes = 4 * (3 + 7 * 2) + 2 + 4 * 4 + 2            # floats, bools
    out_bytes = (4 * 2 * (1 + 1 + 1 + 4 + 2 + 3)          # 12 [1, 2] planes
                 + 4 * 2 + 4 * 6 + 8 * 6 + 2)   # col_sum, cand, unused
    flop = 2 * 60 + 1 * 2 * (27 + 2 * T)
    assert bounds.map_update_work(args, out, T) == (in_bytes + out_bytes,
                                                    flop)
    assert bounds.map_update_bound(args, out, T) == (
        pytest.approx((in_bytes + out_bytes) / B), "bytes")
