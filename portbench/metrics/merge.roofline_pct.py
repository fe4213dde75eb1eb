"""The merge phase's share of its roofline: the least time the card could
take for the merge fixpoint's work on each call's compacted input
(``bounds.merge_bound``, the passes traced with the reference's twin),
over the device time of every kernel launched inside ``ops/gm.py::merge``
(the compaction and the ``merge2d`` or ``merge3d`` kernel).  Counted by
phase, so it reads the same work whatever implements it."""

import torch

from portbench import bounds
from portbench.reference import gm as twin
from portbench.reference.state import GMState

RANGES = {"rbphd.merge": "rfs_slam_tpu_torch.ops.gm:merge"}
CAPTURES = {"merge": "rfs_slam_tpu_torch.ops.gm:merge"}


def work(name, args, kwargs):
    gm, threshold, inflation = args[:3]
    with torch.no_grad():
        g = GMState(gm.mean, gm.cov, gm.w, gm.w_prev, gm.alive)
        g = twin.compact(g, g.capacity)
        return bounds.merge_bound(g, threshold, inflation)[0]


def read(runs, card):
    dev = sum(r["ranges"]["rbphd.merge"]["device_s"] for r in runs)
    least = sum(r["work_s"].get("merge", 0.0) for r in runs)
    return 100.0 * least / dev if dev and least else None
