"""On the card only (skip elsewhere): a short run of each cell through
the command, and the control, the reference computed with TF32 matmuls in
the program's place, coming out as not correct at the cell's own size."""

import argparse
import json
import os
import subprocess
import sys

import pytest

from portbench import check, run, spec

CELLS = ["rbphd2d-sweep8", "vp-rbphd-sweep8"]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_is_correct(card, name):
    out = subprocess.run(
        [sys.executable, os.path.join(spec.HERE, "run.py"), "--workload",
         name, "--seed", "4294967311", "--seconds", "8", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["check"]
    assert line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == set(spec.cell(name)["end_to_end"])


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(card, name):
    c = spec.cell(name)
    run.cache_dirs()
    from rfs_slam_tpu_torch.ops.kernels import build

    build.load_all(c["config"]["kernels"])
    ns = argparse.Namespace(seed=4294967353, seconds=8, trace=0)
    start, got, errors = run.launch(c, ns, ("sound", "tf32"))
    assert not errors and start is not None, errors
    limits = c["cell"]["check"]["limits"]
    rows = [r for g in got for r in g["readings"]]
    assert check.verdict(check.worst([r["sound"] for r in rows]), limits)
    assert not check.verdict(check.worst([r["tf32"] for r in rows]), limits)
