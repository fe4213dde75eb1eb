"""Per-phase timing report, the reference's TimingInfo (port of the JAX
package's ``utils/timing.py``).

Reference: per-phase boost cpu_timers in the filters (RBPHDFilter.hpp:
278-284, Timer.hpp:42-75) exposed by ``getTimingInfo()`` (:1219-1232) and
logged to ``timing.dat`` (rbphdslam2dSim.cpp:654-732).  A phase is timed as
its own call: the host's wall clock around the call and its wait for the
device, the process's CPU time (the host's launch work), and on the card the
device time between CUDA events recorded around the call.
"""

from __future__ import annotations

import time

import torch

from rfs_slam_tpu_torch.ops import gm as gm_ops
from rfs_slam_tpu_torch.ops.ekf import correct_all


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
