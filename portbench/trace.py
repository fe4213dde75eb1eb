"""The traced stretch of a run: profiler ranges and argument captures
installed from the benchmark's files around the program's calls, and the
reduction of the profiler's events to what the per-layer readers read.

A run's stretch starts and ends on a synchronised device (so every kernel
in it belongs to the stretch's steps) and is marked by a ``pb.stretch``
range, whose host interval gives the stretch in the profiler's clock.  A
kernel belongs to a range where the host call that launched it (matched by
the profiler's correlation id) lies inside one of the range's host
intervals: a range nested in one of its own name counts once.
"""

from __future__ import annotations

import bisect
import collections
import importlib

import torch

from portbench import stats

STRETCH = "pb.stretch"


def resolve(target: str, filt):
    """``(owner, attribute)`` of a target: ``filter.<attr>`` the run's
    filter object, ``<module>:<attr>`` a module's attribute."""
    if target.startswith("filter."):
        return filt, target[len("filter."):]
    mod, attr = target.split(":")
    return importlib.import_module(mod), attr


class Instruments:
    """The ranges and captures of a traced run, wrapped around the
    program's calls in this process only."""

    def __init__(self, filt, ranges: dict, captures: dict):
        self.active = False
        self.calls = collections.defaultdict(list)   # capture -> [(a, k)]
        self._undo = []
        for name, targets in ranges.items():
            for target in ([targets] if isinstance(targets, str)
                           else targets):
                self._wrap(resolve(target, filt), self._ranged(name))
        for name, target in captures.items():
            self._wrap(resolve(target, filt), self._captured(name))

    def _wrap(self, where, make):
        owner, attr = where
        fn = getattr(owner, attr)
        setattr(owner, attr, make(fn))
        self._undo.append((owner, attr, fn))

    def _ranged(self, name):
        def make(fn):
            def wrapped(*a, **k):
                with torch.profiler.record_function(name):
                    return fn(*a, **k)
            return wrapped
        return make

    def _captured(self, name):
        def make(fn):
            def wrapped(*a, **k):
                if self.active:
                    self.calls[name].append((a, k))
                return fn(*a, **k)
            return wrapped
        return make

    def remove(self):
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo = []


def warm_profiler(device) -> None:
    """Start and stop the profiler once in set-up: the first start
    initialises the device tracer, which takes seconds."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        (torch.zeros(8, device=device) + 1).sum()
        torch.cuda.synchronize(device)


class Stretch:
    """Starts and stops the profiler on a synchronised device."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self._mark = None

    def start(self):
        torch.cuda.synchronize(self.device)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self._mark = torch.profiler.record_function(STRETCH)
        self._mark.__enter__()

    def stop(self):
        torch.cuda.synchronize(self.device)
        self._mark.__exit__(None, None, None)
        self.prof.stop()


def _is_annotation(e) -> bool:
    fn = getattr(e, "is_user_annotation", None)
    if fn is not None and fn():
        return True
    kind = getattr(e, "activity_type", None)
    return kind is not None and "annotation" in str(kind()).lower()


def reduce(prof, range_names) -> dict:
    """One run's stretch from its profiler events, times in ns of the
    profiler's clock: ``stretch`` (start, end); ``busy`` the union of its
    device intervals (kernels, copies, sets) as a list of (start, end);
    ``launches`` their count; ``ops`` device seconds by operation name;
    ``ranges`` per range name its host intervals and the device seconds of
    the kernels launched inside them."""
    cuda = torch.autograd.DeviceType.CUDA
    kernels, launch_at = [], {}
    hosts = {name: [] for name in range_names}
    stretch = None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        a = e.start_ns()
        b = a + e.duration_ns()
        if e.device_type() == cuda:
            if not (_is_annotation(e) or name in hosts or name == STRETCH):
                kernels.append((a, b, name, e.correlation_id()))
            continue
        if name == STRETCH:
            stretch = (a, b)
        elif name in hosts:
            hosts[name].append((a, b))
        elif e.correlation_id():
            launch_at[e.correlation_id()] = a
    if stretch is None:
        raise RuntimeError("the profiler recorded no stretch")
    lo, hi = stretch
    kernels = [k for k in kernels if k[1] > lo and k[0] < hi]
    ops = collections.Counter()
    for a, b, name, _ in kernels:
        ops[name] += (b - a) / 1e9
    ranges = {}
    for name, ivs in hosts.items():
        merged = _merge(ivs)
        starts = [m[0] for m in merged]
        dev = 0.0
        for a, b, _, corr in kernels:
            t = launch_at.get(corr)
            if t is None:
                continue
            i = _bisect(starts, t)
            if i >= 0 and t < merged[i][1]:
                dev += (b - a) / 1e9
        ranges[name] = {"host": merged, "device_s": dev,
                        "calls": len(merged)}
    return {"stretch": stretch, "busy": _merge([(a, b)
                                                 for a, b, _, _ in kernels]),
            "launches": len(kernels), "ops": dict(ops.most_common(30)),
            "ranges": ranges}


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _bisect(starts, t) -> int:
    return bisect.bisect_right(starts, t) - 1


def card(runs) -> dict:
    """The card over the stretch that every run traced: ``window_s`` its
    length, ``busy_s`` the union of all runs' device intervals in it (the
    runs' contexts time-slice the card), ``idle`` the gaps longer than
    10 us labelled by the range most runs' hosts were in (``host loop``
    where none), ``ops`` the device seconds by operation over all runs."""
    lo = max(r["stretch"][0] for r in runs)
    hi = min(r["stretch"][1] for r in runs)
    if hi <= lo:
        raise RuntimeError("the runs' traced stretches do not overlap")
    busy = [iv for r in runs for iv in r["busy"]]
    busy_ns = stats.union_length(busy, lo, hi)
    idle = collections.Counter()
    labels = [_labeller(r) for r in runs]
    for a, b in stats.gaps(busy, lo, hi):
        if b - a < 10_000:
            continue
        mid = (a + b) / 2
        votes = collections.Counter(label(mid) for label in labels)
        idle[votes.most_common(1)[0][0]] += (b - a) / 1e9
    ops = collections.Counter()
    for r in runs:
        ops.update(r["ops"])
    return {"window_s": (hi - lo) / 1e9, "busy_s": busy_ns / 1e9,
            "idle": idle, "ops": ops}


def _labeller(run):
    """``label(t)``: the innermost range (the one whose interval started
    last) that holds ``t`` in a run's host, or ``host loop``."""
    per = [(name, [iv[0] for iv in r["host"]], r["host"])
           for name, r in run["ranges"].items()]

    def label(t):
        best, best_start = "host loop", None
        for name, starts, ivs in per:
            i = _bisect(starts, t)
            if i >= 0 and t < ivs[i][1] and (best_start is None
                                             or ivs[i][0] > best_start):
                best, best_start = f"host in {name}", ivs[i][0]
        return best

    return label
