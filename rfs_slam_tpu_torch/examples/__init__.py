"""Runnable examples mirroring the reference's ``bin/examples`` programs
(port of the JAX package's ``examples/``).

Reference: CMakeLists.txt:169-189 builds five example executables
(``linearAssignment_{MurtyAlgorithm,CostMatrixPartitioning,
LexicographicOrdering}``, ``ospaError``, ``spatialIndexTree``).  Each
module runs as ``python -m rfs_slam_tpu_torch.examples.<name> [--device
cpu]`` (default: the card), and validates itself as the reference examples
do.
"""

from __future__ import annotations

import argparse

import torch


def device_of(device) -> torch.device:
    """The device an example runs on: the card unless the caller names
    another."""
    return torch.device("cuda" if device is None else device)


def cli(main, doc: str):
    """Run ``main(device=...)`` from the command line."""
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    return main(device=ap.parse_args().device)
