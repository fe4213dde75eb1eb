"""Device time a step of the kernels launched inside the program's
``rbphd.births`` span (``RBPHDFilter._add_birth_gaussians``: inside
predict on the 2-D path, called on its own at the start of each Victoria
Park frame).  A program without the span reads nothing."""

RANGES = {"rbphd.births": []}


def read(runs, card):
    steps = sum(r["traced_steps"] for r in runs)
    dev = sum(r["ranges"]["rbphd.births"]["device_s"] for r in runs)
    return 1e3 * dev / steps if steps and dev else None
