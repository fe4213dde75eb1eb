"""Device time a step of the kernels launched inside the program's
``rbphd.map_update`` span (``RBPHDFilter._map_update``: on the 2-D path the
``map_update2d`` kernel, the top-k of the new Gaussians and their
insertion; on the Victoria Park path the plain head and the same tail).
Declared with the target ``map_update.roofline_pct`` wraps, so that the
readers' merged ranges keep that wrap for a program without the span; the
program's span, nested in the wrap of its name, reads the same."""

RANGES = {"rbphd.map_update": "filter._map_update"}


def read(runs, card):
    steps = sum(r["traced_steps"] for r in runs)
    dev = sum(r["ranges"]["rbphd.map_update"]["device_s"] for r in runs)
    return 1e3 * dev / steps if steps and dev else None
