"""One run of a cell, in a process of its own: set-up (data, filter,
warm-up), the window from the common start to the deadline, then, once
the card's memory has been read and the program's state dropped, the
traced stretch's reduction and the comparison with the reference."""

from __future__ import annotations

import os
import resource
import sys
import time

import torch

from portbench import faults, spec, trace
from portbench.drivers.common import Deadline, sample_steps

FORBIDDEN = ("jax", "jaxlib", "flax", "rfs_slam_tpu")


def loaded_forbidden() -> list[str]:
    """The modules of JAX or the JAX package in this process, compared by
    their whole top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Clock:
    """The window's step clock: a CUDA event recorded after each step (on
    the card), the host's time of each step's end of enqueue, the
    deadline, and in a traced run the profiled stretch and the process CPU
    time of the steps outside it."""

    def __init__(self, device, start: float, deadline: float, stretch=None,
                 instruments=None):
        self.device = device
        self.cuda = device.type == "cuda"
        self.deadline = deadline
        self.n = 0
        self.host = []
        self.events = [self._event() for _ in range(4096)] if self.cuda \
            else []
        self.stretch, self.instruments = stretch, instruments
        self.traced_steps = 0
        self.traced = (0, 0)        # the steps profiled, first and last
        self.cpu_s = 0.0
        self.cpu_steps = 0
        self._cpu0 = time.process_time()
        self._state = "before"      # before -> in -> after the stretch
        # the steps done by each whole second of the window
        self.progress = []
        self._next_mark = start + 1

    def _event(self):
        return torch.cuda.Event(enable_timing=True)

    def tick(self) -> None:
        if self.cuda:
            if self.n == len(self.events):
                self.events.append(self._event())
            self.events[self.n].record()
        self.n += 1
        now = time.monotonic()
        self.host.append(now)
        while now >= self._next_mark:
            self.progress.append(self.n)
            self._next_mark += 1
        if self.stretch is not None:
            self._trace(now)
        if now >= self.deadline:
            raise Deadline()

    def _trace(self, now) -> None:
        cpu = time.process_time()
        if self._state == "in":
            self.traced_steps += 1
            self.traced = (self.traced[0], self.n)
            if now >= self.stretch_end:
                self.instruments.active = False
                self.stretch.stop()
                self._state = "after"
                self._cpu0 = time.process_time()
            return
        self.cpu_s += cpu - self._cpu0
        self.cpu_steps += 1
        self._cpu0 = cpu
        if self._state == "before" and now >= self.stretch_start:
            self.stretch.start()
            self.instruments.active = True
            self._state = "in"
            self.traced = (self.n + 1, self.n)

    def close(self) -> None:
        """End a stretch the deadline cut."""
        if self.stretch is not None and self._state == "in":
            self.instruments.active = False
            self.stretch.stop()
            self._state = "after"

    def intervals_ms(self) -> list[float]:
        """The intervals between consecutive steps' completions."""
        ev = self.events[:self.n]
        return [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]

    def untraced(self, intervals: list[float]) -> list[float]:
        """``intervals`` without those that end in or right after the
        profiled stretch (counting steps from 1, as ``n`` does, interval
        ``j`` ends at step ``j + 2``)."""
        first, last = self.traced
        return [x for j, x in enumerate(intervals)
                if not first <= j + 2 <= last + 1]


def run_one(task: dict, wait_start, after_window, fault=None) -> dict:
    """One run.  ``wait_start()`` blocks until every run is ready and
    returns the common start (``time.monotonic()``); ``after_window(index,
    device)`` blocks until every run has closed its window and returns the
    card's memory in use then (0 where not read).  ``fault(driver)``, for
    tests, breaks the program under the driver before the window; without
    it, the task's ``fault`` names one of :mod:`portbench.faults`, or
    None."""
    stages = [("begin", time.monotonic())]
    torch.set_num_threads(task["threads"])
    dev = torch.device(task["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    c = task["spec"]
    cfg, cell = c["config"], c["cell"]
    chk = cell["check"]
    mod = spec.driver(cfg["driver"])
    samples = sample_steps(task["seed"], task["index"], chk["sample"],
                           *chk["within"])
    drv = mod.Driver(cfg, task["index"], task["seed"], dev, samples)
    stages.append(("built", time.monotonic()))
    if fault is None and task.get("fault"):
        fault = faults.FAULTS[task["fault"]]
    if fault is not None:
        fault(drv)
    readers = {m: spec.metric(m) for m in c["per_layer"]} if task["trace"] \
        else {}
    ranges, captures = {}, {}
    for r in readers.values():
        ranges.update(getattr(r, "RANGES", {}))
        captures.update(getattr(r, "CAPTURES", {}))
    inst = trace.Instruments(drv.filt, ranges, captures) if readers \
        else None
    try:
        if inst is not None:
            trace.warm_profiler(dev)
        drv.warm()
        stages.append(("warm", time.monotonic()))
        start = wait_start()
        while time.monotonic() < start:
            time.sleep(0.001)
        seconds = task["seconds"]
        stretch = None
        if inst is not None:
            stretch = trace.Stretch(dev)
        clock = Clock(dev, start, start + seconds, stretch, inst)
        if stretch is not None:
            t = cell["trace"]
            clock.stretch_start = start + t["start_s"]
            clock.stretch_end = clock.stretch_start + t["length_s"]
        ru0 = resource.getrusage(resource.RUSAGE_SELF)
        try:
            drv.window(clock.tick)
        except Deadline:
            pass
        clock.close()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        end = time.monotonic()
        ru1 = resource.getrusage(resource.RUSAGE_SELF)
        mem = after_window(task["index"], dev)
        drv.release()
        intervals = clock.intervals_ms()
        out = {"index": task["index"], "steps": clock.n, "start": start,
               "end": end, "intervals_ms": intervals,
               "memory_used": mem, "stages": stages,
               "progress": clock.progress,
               "host_s": [t - start for t in clock.host],
               "switches": (ru1.ru_nvcsw - ru0.ru_nvcsw,
                            ru1.ru_nivcsw - ru0.ru_nivcsw)}
        if inst is not None:
            inst.remove()
            if stretch.prof is None:
                raise RuntimeError("the window closed before the traced "
                                   "stretch began")
            red = trace.reduce(stretch.prof, list(ranges))
            red["work_s"] = {
                name: sum(readers_work(readers, name, a, k)
                          for a, k in calls)
                for name, calls in inst.calls.items()}
            inst.calls.clear()
            red.update(intervals_ms=clock.untraced(intervals),
                       traced_steps=clock.traced_steps, cpu_s=clock.cpu_s,
                       cpu_steps=clock.cpu_steps)
            out["trace"] = red
        out["readings"] = drv.check(tuple(task["modes"]))
        out["forbidden"] = loaded_forbidden()
        return out
    finally:
        if hasattr(drv, "close"):
            drv.close()


def readers_work(readers, capture: str, args, kwargs) -> float:
    """The least seconds the card needs for one captured call, from the
    reader that declared the capture."""
    for r in readers.values():
        if capture in getattr(r, "CAPTURES", {}):
            return r.work(capture, args, kwargs)
    raise KeyError(capture)


def main(task: dict, barriers, start_value, results) -> None:
    """A spawned run: the barriers are the parent's (ready, go, window
    closed, memory read); the result, or the error, goes to ``results``."""
    os.environ.setdefault("USE_FLAX", "0")
    timeout = task["barrier_timeout"]

    def wait_start():
        barriers[0].wait(timeout)
        barriers[1].wait(timeout)
        return start_value.value

    def after_window(index, dev):
        barriers[2].wait(timeout)
        used = 0
        if index == 0 and dev.type == "cuda":
            free, total = torch.cuda.mem_get_info(dev)
            used = total - free
        barriers[3].wait(timeout)
        return used

    try:
        out = run_one(task, wait_start, after_window)
        if task["index"] == 0 and task["device"].startswith("cuda"):
            out["device_name"] = torch.cuda.get_device_name(
                torch.device(task["device"]))
        results.put(("ok", out))
    except BaseException as e:   # the parent reports it and fails the run
        import traceback
        for b in barriers:
            b.abort()
        results.put(("error", {"index": task["index"],
                               "error": traceback.format_exc()}))
        if not isinstance(e, Exception):
            raise
