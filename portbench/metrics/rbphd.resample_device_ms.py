"""Device time a step of the kernels launched inside the program's
``rbphd.resample`` span (``RBPHDFilter._resample_phase``: the ESS gate,
the ancestors and the gather of every particle's map and state behind
them).  A program without the span reads nothing."""

RANGES = {"rbphd.resample": []}


def read(runs, card):
    steps = sum(r["traced_steps"] for r in runs)
    dev = sum(r["ranges"]["rbphd.resample"]["device_s"] for r in runs)
    return 1e3 * dev / steps if steps and dev else None
