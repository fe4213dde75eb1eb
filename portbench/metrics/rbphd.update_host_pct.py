"""The filter's update's share of the host's wall time over the profiled
stretch: each run's host intervals inside ``rbphd.update`` (the span of
``RBPHDFilter.update``) over the stretch's length, pooled over the runs.
Set beside ``rbphd.update_device_ms``, how far the phase holds the host.
A share of two walls under the same profiler, so the profiler's cost a
recorded op, and a host slowed by the other runs, weigh on both sides
alike; the wall of the update alone would carry them.  Declared with the
target ``rbphd.update_device_ms`` wraps, so that the readers' merged ranges
keep that wrap for a program without the span."""

RANGES = {"rbphd.update": "filter.update"}


def read(runs, card):
    inside = whole = 0
    for r in runs:
        lo, hi = r["stretch"]
        whole += hi - lo
        inside += sum(max(0, min(b, hi) - max(a, lo))
                      for a, b in r["ranges"]["rbphd.update"]["host"])
    return 100.0 * inside / whole if whole and inside else None
