"""Cells, configurations, mixes and metrics are found by name, and a new
cell is added as files alone."""

import json
import os
import shutil

from portbench import spec


def test_cells_load_by_name():
    bench = spec.benchmark()
    for w in bench["workloads"]:
        c = spec.cell(w["name"])
        assert c["config"]["name"] == w["config"]
        assert c["traffic"]["name"] == w["traffic"]
        assert c["cell"]["name"] == w["name"]
        assert {"steps_per_s", "setup_s"} <= set(c["end_to_end"])
        assert c["per_layer"], w["name"]
        for m in c["per_layer"]:
            assert hasattr(spec.metric(m), "read"), m
        assert spec.driver(c["config"]["driver"]).Driver


def test_the_step_tail_is_bounded_only_where_it_holds_still():
    """The VP frames' tail is an end-to-end metric; the 2-D steps' tail,
    paced by the card's time-slicing, a per-layer one."""
    vp, sim = spec.cell("vp-rbphd-sweep8"), spec.cell("rbphd2d-sweep8")
    assert "step_ms_p95" in vp["end_to_end"]
    assert "step_ms_p95" not in sim["end_to_end"]
    assert "loop.step_ms_p95" in sim["per_layer"]
    assert "loop.step_ms_p95" not in vp["per_layer"]


def test_map_update_roofline_only_where_its_kernel_runs():
    assert "map_update.roofline_pct" in spec.cell("rbphd2d-sweep8")[
        "per_layer"]
    assert "map_update.roofline_pct" not in spec.cell("vp-rbphd-sweep8")[
        "per_layer"]


def test_a_new_cell_is_files_alone(tmp_path):
    """A copy of the benchmark with a new mix, cell and metric added as
    files (and entries in BENCHMARK.json): the harness finds them."""
    here = tmp_path / "portbench"
    shutil.copytree(spec.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.benchmark()
    (here / "traffic" / "sweep12.json").write_text(json.dumps(
        {"name": "sweep12", "what": "12 runs", "runs": 12,
         "threads_per_run": 1}))
    (here / "cells" / "rbphd2d-sweep12.json").write_text(json.dumps(
        {"name": "rbphd2d-sweep12", "mirrors": "-",
         "check": {"sample": 3, "within": [101, 1000],
                   "limits": {"pose_gap": 1e-5}},
         "trace": {"start_s": 4.0, "length_s": 2.0}}))
    (here / "metrics" / "loop.steps_traced.py").write_text(
        "def read(runs, card):\n"
        "    return sum(r['traced_steps'] for r in runs)\n")
    bench["workloads"].append({"name": "rbphd2d-sweep12",
                               "config": "rbphd2d-sim",
                               "traffic": "sweep12", "chips": 1,
                               "why": "-"})
    bench["per_layer"].append({"name": "loop.steps_traced", "unit": "steps",
                               "better": "higher", "source": "device_trace",
                               "layer": "run loop", "moves": "steps_per_s",
                               "workloads": ["rbphd2d-sweep12"]})
    for c in bench["configs"]:
        src = os.path.join(spec.ROOT, c["file"])
        dst = tmp_path / c["file"]
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(src, dst)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.cell("rbphd2d-sweep12", root=str(tmp_path), here=str(here))
    assert c["traffic"]["runs"] == 12
    assert c["per_layer"] == ["loop.steps_traced"]
    reader = spec.metric("loop.steps_traced", here=str(here))
    assert reader.read([{"traced_steps": 3}, {"traced_steps": 4}], {}) == 7


def test_benchmark_json_keeps_the_contract_shape():
    bench = spec.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "portbench/run.py"]
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for c in bench["configs"]:
        cfg = json.load(open(os.path.join(spec.ROOT, c["file"])))
        assert cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
