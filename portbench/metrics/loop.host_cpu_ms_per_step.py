"""The run loop's host CPU time a step: each run's process CPU time over
its steps outside the profiled stretch, averaged over the runs.  CPU time,
not wall time: a run whose launch queue is full waits without working."""


def read(runs, card):
    per = [r["cpu_s"] / r["cpu_steps"] for r in runs if r["cpu_steps"]]
    return 1e3 * sum(per) / len(per) if per else None
