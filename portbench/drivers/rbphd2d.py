"""The 2-D simulation's run: data from the benchmark's generator, the
port's filter from ``apps/rbphdslam2dsim.py::build_filter``, and the
port's step loop ``apps/sim2d_common.py::steps`` over whole 3,000-step
streams, back to back.

A stream with a step that sees more measurements than the configured
capacity runs at that step's count, rounded up to a multiple of 16, as
the port's batch study does (``apps/batchsim.py::run_one``)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench import check
from portbench.drivers.common import Sampler, run_seeds
from portbench.gen import sim2d as gen2d
from portbench.reference import wiring

MAX_RESTARTS = 64


class Driver:
    def __init__(self, cfg: dict, index: int, seed: int, device,
                 samples: set):
        from rfs_slam_tpu_torch.apps import rbphdslam2dsim as app
        from rfs_slam_tpu_torch.apps import sim2d_common as loop
        from rfs_slam_tpu_torch.filters.rbphd import RBPHDFilter
        from rfs_slam_tpu_torch.io import sim2d

        self.cfg, self.device, self.loop = cfg, device, loop
        traj, noise, *self.gen_seeds = run_seeds(seed, index,
                                                 2 + MAX_RESTARTS)
        self.sim = gen2d.Sim2DConfig(**cfg["sim"])
        self.data, zc = stream(self.sim, traj, noise,
                               cfg["filter"]["z_capacity"])
        if zc != cfg["filter"]["z_capacity"]:
            cfg = {**cfg, "filter": {**cfg["filter"], "z_capacity": zc}}
            self.cfg = cfg
        f = cfg["filter"]
        self.filt = app.build_filter(sim2d.Sim2DConfig(**cfg["sim"]), device,
                                     n_particles=f["n_particles"],
                                     map_capacity=f["map_capacity"])
        if self.filt.cfg.z_capacity != zc:
            self.filt = RBPHDFilter(
                self.filt.motion, self.filt.lmk, self.filt.meas,
                self.filt.gates, dataclasses.replace(self.filt.cfg,
                                                     z_capacity=zc))
        self.ref = wiring.filter2d(cfg, device)
        conforms(self.filt, self.ref)
        self.din = loop.device_inputs(loop.sim_inputs(
            self.data, z_capacity=zc), device)
        self.sampler = Sampler(samples)

    # ---------------------------------------------------------------- run
    def warm(self) -> None:
        """Steps of every kind the window runs, on a throwaway state: locked
        steps with and without measurements, free steps, a resample."""
        has_z = self.din[-1]
        empty = np.nonzero(~has_z)[0]
        idx = list(range(4)) + list(range(150, 156)) + list(empty[:2])
        part = tuple(a[idx] for a in self.din)
        gen = torch.Generator(device=self.device).manual_seed(1)
        self.loop.steps(self.filt, part, gen, self.sim.dt, lambda k, s: None)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, tick) -> None:
        """Whole streams back to back until ``tick`` raises; step ``n`` of
        the window is the ``n``-th call of ``tick``."""
        T = len(self.din[-1])
        n = 0
        for restart in range(MAX_RESTARTS):
            gen = torch.Generator(device=self.device).manual_seed(
                self.gen_seeds[restart])
            self.sampler.before(n, 0, None, gen)

            def on_step(k, state):
                nonlocal n
                self.sampler.after(n, state)
                if k + 1 < T:
                    self.sampler.before(n + 1, k + 1, state, gen)
                n += 1
                tick()

            self.loop.steps(self.filt, self.din, gen, self.sim.dt, on_step)
        raise RuntimeError("the window outlasted its restarts")

    def release(self) -> None:
        self.din = None

    # --------------------------------------------------------- reference
    def check(self, modes=("sound",)) -> list[dict]:
        """Each kept step recomputed by the reference from the state before
        it, its inputs and its draws; per step and mode, the numbers of
        :mod:`portbench.check`: ``sound`` the program against the
        reference, ``tf32`` the reference with TF32 matmuls against it."""
        d, dt = self.data, self.sim.dt
        lock_steps = self.cfg["models"]["gt_lock_steps"]
        def put(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), dtype=dtype,
                                   device=self.device)

        out = []
        for s in self.sampler.done():
            k, t = s["k"], s["k"] + 1          # stream index, timestep
            args = (put(d.odometry[t]), put(d.z[t]),
                    put(d.z_mask[t], torch.bool), put(d.gt_pose[t]),
                    t <= lock_steps, bool(d.z_mask[t].any()))

            def ref_step(s=s, args=args):
                gen = torch.Generator(device=self.device)
                gen.set_state(s["gen"])
                pre = (wiring.init2d(self.ref, self.device)
                       if s["pre"] is None else wiring.state_from(s["pre"]))
                return wiring.step2d(self.ref, pre, *args, gen, dt)

            out.append(dict(step=s["n"], k=k, **readings(ref_step, s["post"],
                                                         modes)))
        return out


def stream(sim, traj: int, noise: int, z_capacity: int):
    """``(data, capacity)``: the stream at the configured capacity, or,
    where a step sees more, at that count rounded up to a multiple of 16
    (``apps/batchsim.py::run_one``)."""
    try:
        return gen2d.generate(sim, traj_seed=traj, noise_seed=noise,
                              z_capacity=z_capacity), z_capacity
    except ValueError:
        probe = gen2d.generate(sim, traj_seed=traj, noise_seed=noise)
        zc = max(z_capacity, -(-probe.z.shape[1] // 16) * 16)
        return gen2d.generate(sim, traj_seed=traj, noise_seed=noise,
                              z_capacity=zc), zc


def readings(ref_step, post, modes) -> dict:
    """The numbers of each mode for one kept step."""
    judge = ref_step()
    got = {}
    for mode in modes:
        if mode == "sound":
            got[mode] = check.compare(post, judge)
        elif mode == "tf32":
            with tf32():
                low = ref_step()
            got[mode] = check.compare(low, judge)
        else:
            raise ValueError(f"unknown mode {mode}")
    return got


class tf32:
    """TF32 matmuls (and convolutions) within the block."""

    def __enter__(self):
        b = torch.backends
        self.saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
        b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = True

    def __exit__(self, *exc):
        b = torch.backends
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = self.saved


def conforms(prog_filter, ref_filter) -> None:
    """Raise unless the program's filter is the configuration's: the same
    settings and the same model tensors as the reference wires from the
    configuration file (a run that departs from it is no sound run)."""
    a, b = dataclasses.asdict(prog_filter.cfg), dataclasses.asdict(
        ref_filter.cfg)
    if a != b:
        diff = {k: (a.get(k), b.get(k)) for k in set(a) | set(b)
                if a.get(k) != b.get(k)}
        raise RuntimeError(f"the program's filter departs from the "
                           f"configuration: {diff}")
    for part in ("motion", "lmk", "meas"):
        pa, pb = getattr(prog_filter, part), getattr(ref_filter, part)
        for f in dataclasses.fields(pb):
            va, vb = getattr(pa, f.name), getattr(pb, f.name)
            same = (torch.equal(va.cpu(), vb.cpu())
                    if isinstance(vb, torch.Tensor) else va == vb)
            if not same:
                raise RuntimeError(f"the program's {part}.{f.name} departs "
                                   f"from the configuration: {va} != {vb}")
    ga, gb = prog_filter.gates, ref_filter.gates
    if (tuple(ga.thresholds), tuple(ga.wrap_dims)) != (tuple(gb.thresholds),
                                                       tuple(gb.wrap_dims)):
        raise RuntimeError("the program's gates depart from the "
                           "configuration")
