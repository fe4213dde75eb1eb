"""Device operations launched a step (kernels, copies and sets, as the
profiler records them) over the profiled stretch of every run."""


def read(runs, card):
    steps = sum(r["traced_steps"] for r in runs)
    return sum(r["launches"] for r in runs) / steps if steps else None
