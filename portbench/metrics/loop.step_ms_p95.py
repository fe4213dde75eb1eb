"""The 95th percentile of the intervals between consecutive steps'
completions over all runs (CUDA events, as the end-to-end ``step_ms_p95``
takes them), leaving out the intervals of the profiled stretch.  Where the
card's eight contexts time-slice short steps, this tail follows the
contexts' scheduling and the host's state from machine to machine, so it
stands here without a bound."""

from portbench import stats


def read(runs, card):
    values = [x for r in runs for x in r.get("intervals_ms", [])]
    return stats.p95(values) if len(values) >= 2 else None
