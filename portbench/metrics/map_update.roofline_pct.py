"""The map-update phase's share of its roofline: the least time the card
could take for the 2-D map-update head's work (``bounds.map_update_bound``
of each call's inputs, the outputs worked out by the reference's twin),
over the device time of every kernel launched inside the phase
(``RBPHDFilter._map_update``: the head, the top-k of the new Gaussians and
their insertion).  Counted by phase, so it reads the same work whatever
implements it."""

import torch

from portbench import bounds
from portbench.reference import map_update2d as twin

RANGES = {"rbphd.map_update": "filter._map_update"}
CAPTURES = {"map_update2d": "rfs_slam_tpu_torch.filters.rbphd:"
            "fused_map_update2d"}


def work(name, args, kwargs):
    T = kwargs.get("new_per_z", args[12] if len(args) > 12 else 8)
    with torch.no_grad():
        out = twin.map_update2d_plain(*args[:12], new_per_z=T)
    return bounds.map_update_bound(args[:12], out, T)[0]


def read(runs, card):
    dev = sum(r["ranges"]["rbphd.map_update"]["device_s"] for r in runs)
    least = sum(r["work_s"].get("map_update2d", 0.0) for r in runs)
    return 100.0 * least / dev if dev and least else None
