"""Device time a step of the kernels launched inside the filter's predict
(births, motion, the landmark step): ``RBPHDFilter.predict`` and, where the
path calls it apart (the Victoria Park frame), ``_add_birth_gaussians``."""

RANGES = {"rbphd.predict": ["filter.predict", "filter._add_birth_gaussians"]}


def read(runs, card):
    steps = sum(r["traced_steps"] for r in runs)
    dev = sum(r["ranges"]["rbphd.predict"]["device_s"] for r in runs)
    return 1e3 * dev / steps if steps and dev else None
