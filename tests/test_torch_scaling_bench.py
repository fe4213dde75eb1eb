"""The weak-scaling harness (``python -m rfs_slam_tpu_torch.parallel.
scaling_bench``) on two gloo ranks on the CPU: its ``.dat`` file reads as
the JAX package's ``scripts/scaling_bench.py`` writes it, its equality
check passes, and a rank whose state was moved makes it exit 1."""

import json
import os

from rfs_slam_tpu_torch.parallel import scaling_bench as sb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--ranks", "2", "--per-device", "4", "--map", "64", "--z", "8",
        "--steps", "2", "--device", "cpu", "--timeout", "120"]
# scripts/scaling_bench.py:116-120
JAX_COLUMNS = ("# n_devices  total_particles  ms_per_step_sharded  "
               "ms_per_step_1dev_same_total  weak_eff  sharding_overhead")


def records(out: str) -> list:
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


def test_two_gloo_ranks_match_one_rank(tmp_path, capsys):
    dat = tmp_path / "scaling_results.dat"
    assert sb.main(ARGS + ["--out", str(dat)]) == 0
    recs = records(capsys.readouterr().out)
    assert len(recs) == 1
    rec = recs[0]
    assert rec["equality"]["ok"] and rec["equality"]["parent_equal"]
    assert rec["equality"]["alive_equal"]
    assert rec["backend"] == "gloo" and rec["particles"] == 8
    assert rec["collectives_per_step"] > 0 and rec["bytes_per_step"] > 0
    assert len(rec["rank_ms_per_step"]) == 2
    assert rec["ms_per_step"] == max(rec["rank_ms_per_step"])

    # the JAX script's header and six columns
    with open(os.path.join(ROOT, "scripts", "scaling_bench.py")) as f:
        jax_src = f.read()
    for part in JAX_COLUMNS[2:].split("  "):
        assert part in jax_src
    lines = dat.read_text().splitlines()
    assert lines[0] == "# platform=cpu per_device_particles=4 steps=2"
    assert lines[1] == JAX_COLUMNS
    cols = lines[2].split()
    assert len(lines) == 3 and len(cols) == 6
    assert cols[:2] == ["2", "8"]
    assert float(cols[2]) == round(rec["ms_per_step"], 3)
    assert float(cols[3]) == round(rec["ms_per_step_one_rank"], 3)
    assert float(cols[4]) == 1.0      # the first n is its own reference
    assert float(cols[5]) == round(rec["sharding_overhead"], 4)


def test_a_perturbed_rank_fails_the_check(tmp_path, capsys):
    assert sb.main(ARGS + ["--out", str(tmp_path / "s.dat"),
                           "--perturb-rank", "1"]) == 1
    rec, = records(capsys.readouterr().out)
    assert not rec["equality"]["ok"]
    assert rec["equality"]["max_abs_pose"] > sb.TOLERANCES["pose"]
