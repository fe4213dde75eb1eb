"""Spatial index: a uniform grid with sorted buckets (port of the JAX
package's ``ops/spatial.py``).

Reference: the ``SpatialIndexTree`` / ``SpatialIndexBox`` quadtree-octree
(SpatialIndexTree.hpp:49-585, SpatialIndexBox.hpp:50-200) with insert,
remove, box query and closest point.  The reference filters never use it
(a library feature).  The JAX package replaces the pointer tree by a grid:

* build: a cell id per point, one stable argsort, left-sided searchsorted
  offsets (a rebuild stands in for insert / remove);
* box query: a membership mask over every point, compacted in index order;
* nearest: a search of the buckets within ``n_rings`` cells of the query's
  cell, at most ``bucket_cap`` points a bucket (the first in bucket order).
  Exact when the true neighbour lies within ``n_rings`` cells and no
  searched bucket holds more than ``bucket_cap`` points; widen the rings or
  shrink the cells otherwise.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import torch

from rfs_slam_tpu_torch.core import planar


class GridIndex(NamedTuple):
    points: torch.Tensor   # [N, D]
    mask: torch.Tensor     # [N]
    origin: torch.Tensor   # [D]
    cell: torch.Tensor     # scalar cell edge
    res: tuple             # grid resolution per dim
    order: torch.Tensor    # [N] point indices sorted by cell id
    starts: torch.Tensor   # [n_cells + 1] offsets into order


def _flat(ij, res):
    flat = ij[..., 0]
    for d in range(1, len(res)):
        flat = flat * res[d] + ij[..., d]
    return flat


def _cell_of(points, origin, cell, res):
    """The cell ``[..., D]`` of each point, clipped to the grid."""
    hi = torch.as_tensor(res, device=points.device) - 1
    ij = torch.floor((points - origin) / cell).to(torch.int64)
    return torch.minimum(torch.clamp(ij, min=0), hi)


def build(points: torch.Tensor, mask: torch.Tensor, origin, cell: float,
          res: tuple) -> GridIndex:
    """Build the index (replaces SpatialIndexTree::addData, :76-140); masked
    points sort last, past every cell."""
    origin = torch.as_tensor(origin, dtype=points.dtype, device=points.device)
    cell = torch.as_tensor(cell, dtype=points.dtype, device=points.device)
    n_cells = 1
    for r in res:
        n_cells *= r
    ids = torch.where(mask, _flat(_cell_of(points, origin, cell, res),
                                  res), n_cells)
    order = torch.argsort(ids, stable=True)
    starts = torch.searchsorted(
        ids[order], torch.arange(n_cells + 1, device=points.device))
    return GridIndex(points, mask, origin, cell, tuple(res), order, starts)


def query_box(idx: GridIndex, lo, hi, max_results: int):
    """Indices of the points inside the axis-aligned box [lo, hi], in index
    order (replaces the SpatialIndexTree box query, :115-140).  Returns
    ``(indices [max_results], valid [max_results] bool)``, -1 where not
    valid; points beyond ``max_results`` are dropped."""
    p = idx.points
    lo = torch.as_tensor(lo, dtype=p.dtype, device=p.device)
    hi = torch.as_tensor(hi, dtype=p.dtype, device=p.device)
    inside = (p >= lo).all(dim=-1) & (p <= hi).all(dim=-1) & idx.mask
    score = torch.where(inside, -torch.arange(p.shape[0], dtype=torch.float32,
                                              device=p.device),
                        float("-inf"))
    _, top = planar.topk_stable(score, max_results)
    valid = inside[top]
    return torch.where(valid, top, -1), valid


def nearest(idx: GridIndex, q: torch.Tensor, n_rings: int = 2,
            bucket_cap: int = 32):
    """Closest indexed point to each query ``q [..., D]`` (SpatialIndexTree
    closest point), searching the buckets within ``n_rings`` cells of the
    query's cell.  Returns ``(index [...], dist [...], found [...])``, index
    -1 where no candidate lies in the searched buckets; among equal
    distances the first candidate in bucket order wins."""
    D = q.shape[-1]
    res = idx.res
    dev = q.device
    qc = _cell_of(q, idx.origin, idx.cell, res)               # [..., D]
    offs = torch.tensor(list(itertools.product(
        range(-n_rings, n_rings + 1), repeat=D)), device=dev)  # [W^D, D]
    cells = qc[..., None, :] + offs                           # [..., W^D, D]
    ok_cell = ((cells >= 0)
               & (cells < torch.as_tensor(res, device=dev))).all(dim=-1)
    flat = torch.where(ok_cell, _flat(cells, res), 0)

    # the bucket contents, bucket_cap a cell
    s = idx.starts[flat]                                      # [..., W^D]
    e = idx.starts[flat + 1]
    gidx = s[..., None] + torch.arange(bucket_cap, device=dev)
    in_bucket = (gidx < e[..., None]) & ok_cell[..., None]
    gidx = gidx.clamp(0, idx.order.shape[0] - 1)
    pt_idx = idx.order[gidx]                                  # [..., W^D, cap]
    diff = idx.points[pt_idx] - q[..., None, None, :]
    d2 = (diff * diff).sum(dim=-1)
    d2 = torch.where(in_bucket & idx.mask[pt_idx], d2, float("inf"))
    d2 = d2.flatten(-2)
    k = torch.argmin(d2, dim=-1, keepdim=True)
    best_d2 = torch.gather(d2, -1, k)[..., 0]
    found = torch.isfinite(best_d2)
    best = torch.gather(pt_idx.flatten(-2), -1, k)[..., 0]
    return torch.where(found, best, -1), torch.sqrt(best_d2), found
