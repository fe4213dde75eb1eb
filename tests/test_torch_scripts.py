"""scripts/batch_strategies_torch.sh on the CPU at a small size: three
strategy blocks (nEvalPt 0, nEvalPt 1, useClusterProcess 1), each with the
two pd rows of the port's batchsim, finite."""

import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_batch_strategies_torch(tmp_path):
    out = tmp_path / "strategies.dat"
    env = dict(os.environ, PYTHON=sys.executable, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        ["bash", os.path.join(ROOT, "scripts", "batch_strategies_torch.sh"),
         str(out), "10", "1", "--particles", "4", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    blocks = {}
    strat = None
    for line in out.read_text().splitlines():
        if line.startswith("# strategy="):
            strat = line.split("=", 1)[1]
            blocks[strat] = []
        elif line.startswith("# filter="):
            assert f"{strat}.xml" in line and "device=cpu" in line
        elif line and not line.startswith("#"):
            blocks[strat].append([float(v) for v in line.split()])
    assert list(blocks) == ["emptyStrat", "singleStrat", "clusterProc"]
    for rows in blocks.values():
        rows = np.array(rows)
        assert rows.shape == (2, 7)
        np.testing.assert_array_equal(rows[:, 0], [0.9, 0.5])
        np.testing.assert_array_equal(rows[:, 1], [0.01, 0.01])
        assert np.isfinite(rows).all()
