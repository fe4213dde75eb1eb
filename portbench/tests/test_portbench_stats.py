"""The benchmark's arithmetic on synthetic readings: the rate over the
whole window with its drain, the tail over all intervals, the idle share
from device intervals, and the comparison numbers."""

import math

import pytest
import torch

from portbench import check, stats, trace


def test_rate_counts_the_drain():
    # two runs from a common start at t=10: 100 steps ending at 12.0 and
    # 50 ending at 13.0 (drained late): 150 steps over 3 s, not 2
    assert stats.window_rate([100, 50], 10.0, [12.0, 13.0]) == 50.0


def test_p95_is_over_every_interval_of_every_run():
    a = [10.0] * 95
    b = [100.0] * 5 + [10.0] * 95
    # a median of per-run p95s would read 10; all intervals together: the
    # 5 long ones are the top 2.6%, so the p95 is 10 and the p97.5 is 100
    assert stats.p95(a + b) == pytest.approx(10.0)
    c = [100.0] * 20
    assert stats.p95(a + c) == pytest.approx(100.0)


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (10, 12)]
    assert stats.union_length(iv) == 6
    assert stats.union_length(iv, 1, 11) == 4
    assert stats.gaps(iv, 0, 12) == [(3, 5), (6, 10)]


def _run(stretch, busy, ranges=None):
    return {"stretch": stretch, "busy": busy, "ops": {"k": 1.0},
            "ranges": ranges or {}}


def test_idle_share_from_synthetic_intervals():
    """Two runs time-slicing the card: their intervals add; the window is
    the stretch both traced; overlapping intervals count once."""
    ms = 1_000_000
    r0 = _run((0, 100 * ms), [(10 * ms, 30 * ms), (50 * ms, 60 * ms)])
    r1 = _run((5 * ms, 105 * ms), [(30 * ms, 40 * ms), (55 * ms, 70 * ms)],
              {"rbphd.update": {"host": [(60 * ms, 95 * ms)]}})
    card = trace.card([r0, r1])
    assert card["window_s"] == pytest.approx(0.095)
    # union in [5, 100] ms: 10-40 and 50-70 -> 50 ms
    assert card["busy_s"] == pytest.approx(0.050)
    from portbench import spec
    idle = spec.metric("device.idle_pct").read([r0, r1], card)
    assert idle == pytest.approx(100 * (1 - 50 / 95))
    # gaps: 5-10, 40-50, 70-100 ms; the last one's middle (85 ms) lies in
    # run 1's update, run 0's host loop: the vote goes to the first seen
    assert sum(card["idle"].values()) == pytest.approx(0.045)


def _state(P=4, M=6):
    from portbench.reference.rbphd import RBPHDState
    from portbench.reference.state import (BirthCandidates, GMState,
                                           ParticleState)
    g = torch.Generator().manual_seed(0)
    gm = GMState(torch.randn(2, P, M, generator=g),
                 torch.rand(3, P, M, generator=g), torch.rand(P, M,
                                                              generator=g),
                 torch.rand(P, M, generator=g),
                 torch.rand(P, M, generator=g) > 0.3)
    birth = BirthCandidates.empty(P, 3, 2, torch.device("cpu"))
    parts = ParticleState(torch.randn(P, 3, generator=g),
                          torch.randn(P, generator=g),
                          torch.arange(P))
    zi = torch.zeros((), dtype=torch.int32)
    return RBPHDState(parts, gm, birth, torch.randn(5, 2, generator=g),
                      torch.zeros(P, 5, dtype=torch.bool),
                      torch.zeros(P, dtype=torch.int32), zi, zi)


def test_compare_reads_gaps_and_mismatches():
    import dataclasses
    a = _state()
    assert check.compare(a, check.clone(a)) == {
        "pose_gap": 0.0, "map_gap": 0.0, "map_gap_widest": 0.0,
        "unmatched_share": 0.0, "copies_share": 0.0, "mismatch_share": 0.0,
        "resampled": False, "fields": {}}
    b = check.clone(a)
    b.particles.pose[1, 0] += 1e-3 * float(a.particles.pose.abs().max())
    assert check.compare(b, a)["pose_gap"] == pytest.approx(1e-3, rel=1e-4)
    # a dead slot's values do not count; an alive flag that differs does
    c = check.clone(a)
    dead = (~a.gm.alive).nonzero()[0]
    c.gm.mean[0, dead[0], dead[1]] += 5.0
    assert check.compare(c, a)["map_gap_widest"] == 0.0
    c.gm.alive[dead[0], dead[1]] = True
    assert check.compare(c, a)["mismatch_share"] > 0
    d = dataclasses.replace(a, particles=dataclasses.replace(
        a.particles, log_w=torch.full_like(a.particles.log_w, math.nan)))
    assert check.compare(d, a)["pose_gap"] == math.inf
    assert check.compare(d, check.clone(d))["pose_gap"] == 0.0


def test_one_ancestors_map_may_depart_two_may_not():
    """A threshold decision moved by rounding changes one particle's map:
    ``map_gap`` reads the second widest ancestor, ``map_gap_widest`` the
    widest."""
    a = _state()
    alive = a.gm.alive.nonzero()
    scale = float(a.gm.w[a.gm.alive].abs().max())
    one = check.clone(a)
    p0, m0 = alive[0].tolist()
    one.gm.w[p0, m0] += 0.5 * scale
    got = check.compare(one, a)
    assert got["map_gap"] == 0.0
    assert got["map_gap_widest"] == pytest.approx(0.5, rel=1e-6)
    two = check.clone(one)
    p1, m1 = next(x for x in alive.tolist() if x[0] != p0)
    two.gm.mean[1, p1, m1] += 1.0
    got = check.compare(two, a)
    assert got["map_gap"] > 0.0
    assert got["map_gap_widest"] == pytest.approx(0.5, rel=1e-6)


def _by_ancestor(state, parents):
    """``state`` with particle k a copy of particle ``parents[k]`` and
    ``parents`` as its parents (a resampling's output)."""
    import dataclasses
    idx = torch.tensor(parents)
    f = check.flatten(state)
    out = {}
    for name, v in f.items():
        ax = check.PARTICLE_AXIS.get(name)
        out[name] = v if ax is None else v.index_select(ax, idx)
    out["particles.parent"] = idx.clone()
    from portbench.reference import wiring
    return wiring.state_from(out)


def test_particles_match_by_ancestor():
    """A boundary of the resampling moved: slot 1 takes ancestor 1 in the
    reference, ancestor 0 in the program; every particle still has a
    counterpart of its ancestor, and the states agree."""
    base = _state()
    prog = _by_ancestor(base, [0, 0, 1, 2])
    ref = _by_ancestor(base, [0, 1, 1, 2])
    got = check.compare(prog, ref)
    assert got["map_gap_widest"] == 0.0 and got["unmatched_share"] == 0.0
    assert got["pose_gap"] == 0.0
    # one copy moved from ancestor 1 to ancestor 0: 1 of 4 particles
    assert got["copies_share"] == 0.25 and got["resampled"]
    # an ancestor the reference did not pick is unmatched, not compared
    prog = _by_ancestor(base, [0, 3, 1, 2])
    got = check.compare(prog, ref)
    assert got["unmatched_share"] == 0.25 and got["pose_gap"] == 0.0
    assert got["copies_share"] == 0.25
    # a resampling that ignores the weights: every particle its own
    # ancestor against the reference's picks
    got = check.compare(_by_ancestor(base, [0, 1, 2, 3]),
                        _by_ancestor(base, [0, 0, 0, 2]))
    assert got["unmatched_share"] == 0.5 and got["copies_share"] == 0.5
    assert got["pose_gap"] == 0.0
    # a matched particle that differs is read
    prog.particles.pose[0, 1] += 1.0
    assert check.compare(prog, ref)["pose_gap"] > 0.1


def test_the_traced_tail_leaves_out_the_stretch():
    """Steps 4-6 (counting from 1) were profiled: the intervals ending at
    steps 4-7 go, the others stay, and the reader takes the p95 of what
    every run kept."""
    from portbench import spec, worker
    clock = worker.Clock(torch.device("cpu"), 0.0, 1.0)
    clock.traced = (4, 6)
    intervals = [float(j) for j in range(9)]      # interval j ends at j + 2
    assert clock.untraced(intervals) == [0.0, 1.0, 6.0, 7.0, 8.0]
    reader = spec.metric("loop.step_ms_p95")
    runs = [{"intervals_ms": [10.0] * 95 + [50.0] * 5},
            {"intervals_ms": [10.0] * 100}]
    assert reader.read(runs, {}) == stats.p95([10.0] * 195 + [50.0] * 5)
    assert reader.read([{"intervals_ms": []}], {}) is None
