"""Per-phase timing report, the reference's TimingInfo (port of the JAX
package's ``utils/timing.py``).

Reference: per-phase boost cpu_timers in the filters (RBPHDFilter.hpp:
278-284, Timer.hpp:42-75) exposed by ``getTimingInfo()`` (:1219-1232) and
logged to ``timing.dat`` (rbphdslam2dSim.cpp:654-732).  A phase is timed as
its own call: the host's wall clock around the call and its wait for the
device, the process's CPU time (the host's launch work), and on the card the
device time between CUDA events recorded around the call.

Inside a step the phases are marked instead by :class:`span` ranges and
counted by :func:`tally`, both live only while a ``torch.profiler`` session
records: the filters' spans are named ``<layer>.<phase>`` (``rbphd.update``,
``fastslam.assoc``, ``vp.readback``), and the profiler records them on the
clock of the device's kernels.  With no profiler running a span or a tally
costs one check of the profiler's state.
"""

from __future__ import annotations

import functools
import time

import torch

from rfs_slam_tpu_torch.ops import gm as gm_ops
from rfs_slam_tpu_torch.ops.ekf import correct_all

_profiling = torch._C._autograd._profiler_enabled


class span:
    """A profiler range named ``name`` around a block (``with
    span(name):``) or a function (``@span(name)``), opened only while a
    ``torch.profiler`` session records; otherwise it costs one check of the
    profiler's state.  It never reads the device."""

    __slots__ = ("name", "_range")

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def __enter__(self):
        if _profiling():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        r, self._range = self._range, None
        if r is not None:
            r.__exit__(*exc)
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not _profiling():
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return spanned


_tallied: dict[str, list[torch.Tensor]] = {}
_session_over = False     # a tally ran untraced since the kept ones


def tally(name: str, t: torch.Tensor) -> None:
    """Count ``t``'s sum under ``name`` while a profiler session records:
    keeps a reference to ``t`` (a tensor the step has computed and nothing
    changes in place afterwards), with no launch and no read.  The kept
    tensors live for one session: they can be read after it ends, and the
    first tally of a later session (one after a tally ran untraced) lets
    the unread ones go."""
    global _session_over
    if _profiling():
        if _session_over:
            _tallied.clear()
            _session_over = False
        _tallied.setdefault(name, []).append(t)
    elif _tallied:
        _session_over = True


def tallies(reset: bool = True) -> dict[str, float]:
    """``{name: sum of every tallied tensor}`` since the last reset, read
    with one wait for the device."""
    global _session_over
    if not _tallied:
        return {}
    names = list(_tallied)
    values = torch.stack([sum(t.sum(dtype=torch.float64) for t in _tallied[n])
                          for n in names]).tolist()
    if reset:
        _tallied.clear()
        _session_over = False
    return dict(zip(names, values))


class PhaseTimer:
    """Accumulates wall-clock, host-CPU and (on the card) device time per
    named phase.

    ``device``: the device the phases run on.  On the card each call is
    bracketed by CUDA events and ends in a wait for the second one, so the
    wall time holds the device's work; on the CPU the device column is
    absent.
    """

    def __init__(self, device: torch.device | None = None):
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self.totals: dict[str, float] = {}
        self.cpu_totals: dict[str, float] = {}
        self.device_totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    def time(self, name: str, fn, *args, **kwargs):
        if self.cuda:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        c0 = time.process_time()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if self.cuda:
            end.record()
            end.synchronize()
        dt = time.perf_counter() - t0
        dc = time.process_time() - c0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.cpu_totals[name] = self.cpu_totals.get(name, 0.0) + dc
        if self.cuda:
            self.device_totals[name] = (self.device_totals.get(name, 0.0)
                                        + start.elapsed_time(end) / 1e3)
        self.counts[name] = self.counts.get(name, 0) + 1
        return out

    def report(self) -> dict[str, tuple[float, float]]:
        """{phase: (wall_s, host_cpu_s)}, for io.logs.write_timing."""
        return {k: (v, self.cpu_totals[k]) for k, v in self.totals.items()}

    def table(self) -> str:
        w = max((len(k) for k in self.totals), default=8)
        dev = f"  {'Device (s)':>10}" if self.cuda else ""
        lines = [f"{'Phase':<{w}}  {'Wall (s)':>10}  {'HostCPU (s)':>11}"
                 f"{dev}  {'Calls':>6}"]
        for k, v in self.totals.items():
            dev = (f"  {self.device_totals[k]:>10.4f}" if self.cuda else "")
            lines.append(f"{k:<{w}}  {v:>10.4f}  {self.cpu_totals[k]:>11.4f}"
                         f"{dev}  {self.counts[k]:>6}")
        return "\n".join(lines)


def profile_phases(filt, state, u, dt, z, z_mask, gen: torch.Generator,
                   reps: int = 10) -> PhaseTimer:
    """Time the reference's seven RB-PHD phases separately.

    Phase set and naming per ``RBPHDFilter::TimingInfo`` (RBPHDFilter.hpp:
    152-167): predict, mapUpdate, mapUpdate_kf, particleWeighting,
    mapMerge, mapPrune, particleResample; each is its own call of the
    phase-boundary method that ``update`` composes (``filters/rbphd.py``:
    ``_map_update``, ``_importance_weights``, ``_resample_phase``), and
    ``mapUpdate_kf`` is the per-landmark EKF correction alone.  A full
    update (``fullStep``) of the predicted state is timed once as an
    anchor.
    Draws come from ``gen``.

    Returns a PhaseTimer after ``reps`` passes; a first pass, which builds
    the kernels and fills the allocator's cache, is not counted.
    """
    cfg = filt.cfg
    meas = filt.meas
    nZ = z_mask.sum(dtype=torch.int32)

    def one_pass(timer, s):
        s = timer.time("predict", filt.predict, s, u, dt, gen=gen)
        timer.time("mapUpdate_kf", correct_all, meas, filt.gates,
                   s.particles.pose, s.gm.mean, s.gm.cov, z)
        gmf, lw, unused, nfov, cz = timer.time("mapUpdate", filt._map_update,
                                               s, z, z_mask, meas)
        lw = timer.time("particleWeighting", filt._importance_weights, lw,
                        s.particles.pose, gmf, z, z_mask, cz, nZ, meas)
        gmf = timer.time("mapMerge", gm_ops.merge, gmf, cfg.merge_threshold,
                         cfg.merge_inflation)
        gmf = timer.time("mapPrune", gm_ops.prune, gmf, cfg.prune_threshold)
        u0 = torch.rand((), generator=gen, dtype=lw.dtype, device=lw.device)
        return timer.time("particleResample", filt._resample_phase, s, gmf,
                          lw, unused, nfov, z, nZ, u0)

    device = state.particles.pose.device
    one_pass(PhaseTimer(device), state)
    timer = PhaseTimer(device)
    timer.time("fullStep", filt.update, filt.predict(state, u, dt, gen=gen),
               z, z_mask, gen=gen)
    s = state
    for _ in range(reps):
        s = one_pass(timer, s)
    return timer
