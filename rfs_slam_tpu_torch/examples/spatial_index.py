"""Spatial index demo: populate, box-query, nearest-point, ASCII export.

Equivalent of the reference's ``spatialIndexTree`` example
(src/examples/spatialIndexTree.cpp, driving SpatialIndexTree.hpp:76-140):
insert random 2-D landmarks into the grid spatial index (the fixed-shape
replacement for the quadtree), run an axis-aligned box query and
closest-point queries, validate both against brute force, and export the
occupied-cell layout as ASCII (the reference exports the tree for
``spatialIndexTreeTestVisualizer.py``, SpatialIndexTree.hpp:115).
"""

from __future__ import annotations

import numpy as np
import torch

from rfs_slam_tpu_torch.examples import cli, device_of
from rfs_slam_tpu_torch.ops import spatial


def main(n_points: int = 200, res: int = 8, seed: int = 7,
         out_file: str | None = None, verbose: bool = True, device=None):
    dev = device_of(device)
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0.0, 8.0, size=(n_points, 2))
    idx = spatial.build(torch.as_tensor(pts, dtype=torch.float32, device=dev),
                        torch.ones(n_points, dtype=torch.bool, device=dev),
                        origin=(0.0, 0.0), cell=1.0, res=(res, res))

    # box query vs brute force
    lo, hi = (2.0, 3.0), (5.0, 6.0)
    got, valid = spatial.query_box(idx, lo, hi, max_results=n_points)
    got = set(got[valid].cpu().tolist())
    want = set(np.nonzero(np.all((pts >= lo) & (pts <= hi), axis=1))[0].tolist())
    assert got == want, (sorted(got), sorted(want))
    if verbose:
        print(f"box query [{lo} .. {hi}]: {len(got)} points (validated)")

    # nearest-point queries vs brute force
    qs = rng.uniform(0.5, 7.5, size=(16, 2))
    ni = spatial.nearest(idx, torch.as_tensor(qs, dtype=torch.float32,
                                              device=dev))[0].cpu().numpy()
    for k, q in enumerate(qs):
        bf = int(np.argmin(np.linalg.norm(pts - q, axis=1)))
        assert ni[k] == bf, (k, int(ni[k]), bf)
    if verbose:
        print(f"nearest-point: {len(qs)} queries (validated)")

    # ASCII export of per-cell occupancy
    counts = np.zeros((res, res), int)
    cells = np.clip(pts.astype(int), 0, res - 1)
    for i, j in cells:
        counts[i, j] += 1
    lines = ["occupancy (rows = x cell, cols = y cell):"]
    for i in range(res):
        lines.append(" ".join(f"{counts[i, j]:2d}" for j in range(res)))
    text = "\n".join(lines)
    if out_file:
        with open(out_file, "w") as f:
            f.write(text + "\n")
    if verbose:
        print(text)
    return counts


if __name__ == "__main__":
    cli(main, __doc__)
