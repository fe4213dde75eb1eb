"""Device time a step of the kernels launched inside the filter's update
(the map update, importance weights, merge, prune, resampling)."""

RANGES = {"rbphd.update": "filter.update"}


def read(runs, card):
    steps = sum(r["traced_steps"] for r in runs)
    dev = sum(r["ranges"]["rbphd.update"]["device_s"] for r in runs)
    return 1e3 * dev / steps if steps and dev else None
