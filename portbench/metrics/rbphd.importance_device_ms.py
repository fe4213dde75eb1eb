"""Device time a step of the kernels launched inside the program's
``rbphd.importance`` span (``RBPHDFilter._importance_weights``: the eval
points, the intensities before and after the update and the RFS
likelihood).  A program without the span reads nothing."""

RANGES = {"rbphd.importance": []}


def read(runs, card):
    steps = sum(r["traced_steps"] for r in runs)
    dev = sum(r["ranges"]["rbphd.importance"]["device_s"] for r in runs)
    return 1e3 * dev / steps if steps and dev else None
