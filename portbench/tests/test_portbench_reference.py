"""The reference against the port's step at a tiny size on the CPU (the
port runs its plain twins there), and the comparison failing on each
fault planted under the timed path, through the rest of a run."""

import copy
import time

import pytest

from portbench import check, faults, spec, worker


def tiny(name: str) -> dict:
    c = copy.deepcopy(spec.cell(name))
    cfg = c["config"]
    if cfg["driver"] == "rbphd2d":
        cfg["filter"].update(n_particles=8, map_capacity=32)
        c["cell"]["check"]["within"] = [101, 120]
    else:
        cfg["xml"]["filter.nParticles"] = 4
        cfg["xml"]["filter.resampling.effNParticle"] = 4.0
        cfg["app"]["map_capacity"] = 64
        cfg["stream"].update(frames=40, chunk=10)
        c["cell"]["check"]["within"] = [1, 8]
    return c


def run_cpu(c: dict, seconds: float, seed: int, fault=None) -> dict:
    """One run of the cell on the CPU, past the harness's look for a
    card: its own start, no other runs."""
    task = {"spec": c, "index": 0, "seed": seed, "seconds": seconds,
            "trace": False, "device": "cpu", "threads": 1,
            "modes": ["sound"], "barrier_timeout": 60}
    return worker.run_one(task, time.monotonic, lambda i, d: 0, fault=fault)


@pytest.mark.parametrize("name", ["rbphd2d-sweep8", "vp-rbphd-sweep8"])
def test_reference_equals_the_port_on_the_cpu(name):
    c = tiny(name)
    out = run_cpu(c, 4.0, 2**31 + 977)
    rows = [r["sound"] for r in out["readings"]]
    # the first step and those drawn
    assert len(rows) == 1 + c["cell"]["check"]["sample"]
    assert check.worst(rows) == {"pose_gap": 0.0, "map_gap": 0.0,
                                 "unmatched_share": 0.0, "copies_share": 0.0,
                                 "mismatch_share": 0.0}
    assert max(r["map_gap_widest"] for r in rows) == 0.0
    assert any(r["resampled"] for r in rows)
    assert out["forbidden"] == []


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", ["rbphd2d-sweep8", "vp-rbphd-sweep8"])
def test_a_broken_step_is_not_correct(name, fault):
    c = tiny(name)
    out = run_cpu(c, 3.0, 5, fault=faults.FAULTS[fault])
    rows = [r["sound"] for r in out["readings"]]
    assert rows
    assert not check.verdict(check.worst(rows), c["cell"]["check"]["limits"])


def test_a_stream_past_the_capacity_runs_at_its_own():
    """Run 0 of seed 3000000024 sees 41 measurements at one step: its
    stream keeps them all, and the run takes 48 (the batch study's rule),
    on both sides."""
    from portbench.drivers import common, rbphd2d
    from portbench.gen import sim2d

    c = tiny("rbphd2d-sweep8")
    sim = sim2d.Sim2DConfig(**c["config"]["sim"])
    traj, noise = common.run_seeds(3000000024, 0, 2)
    data, zc = rbphd2d.stream(sim, traj, noise, 40)
    assert zc == 48 and data.z.shape[1] == 48
    assert int(data.z_count.max()) == 41
    out = run_cpu(c, 3.0, 3000000024)
    rows = [r["sound"] for r in out["readings"]]
    assert rows and check.worst(rows)["pose_gap"] == 0.0
