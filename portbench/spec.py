"""Finds what a cell is made of by name: its entry in ``BENCHMARK.json``,
its configuration (the file that entry names), its traffic mix
(``traffic/<mix>.json``), its cell file (``cells/<cell>.json``), the
driver of its configuration (``drivers/<driver>.py``) and the reader of
each per-layer metric it reports (``metrics/<metric>.py``).  A new
configuration, mix, cell or metric is a new file; nothing here changes."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def cell(name: str, root: str = ROOT, here: str = HERE) -> dict:
    """Everything a run of cell ``name`` needs, as plain data:
    ``workload``, ``config``, ``traffic``, ``cell``, ``chips``, the names
    of its ``end_to_end`` and ``per_layer`` metrics."""
    bench = benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m["name"] for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    per_layer = [m["name"] for m in bench["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in e2e
                                  else [])]
    return {"workload": name, "chips": w["chips"],
            "config": _json(os.path.join(root, cfg_entry["file"])),
            "traffic": _json(os.path.join(here, "traffic",
                                          f"{w['traffic']}.json")),
            "cell": _json(os.path.join(here, "cells", f"{name}.json")),
            "end_to_end": e2e, "per_layer": per_layer,
            "units": {m["name"]: m["unit"]
                      for m in bench["end_to_end"] + bench["per_layer"]}}


def driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def metric(name: str, here: str = HERE):
    """The reader module of per-layer metric ``name``
    (``metrics/<name>.py``)."""
    path = os.path.join(here, "metrics", f"{name}.py")
    mod_name = "portbench_metric_" + "".join(
        c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
