"""The Victoria Park path's run: a synthetic stream from the benchmark's
generator written into the run's temporary directory with an XML config of
the configuration's settings, the port's app wired from them
(``apps/rbphdslam_victoriapark.py::build``, ``io/victoria_park.load``),
and the app's chunked frame loop (``apps/_vp_common.py::chunked_scan``, a
read-back of each chunk's outputs, no snapshots) over the stream, streams
back to back."""

from __future__ import annotations

import os
import shutil
import tempfile

import torch

from portbench.drivers.common import Sampler, run_seeds
from portbench.drivers.rbphd2d import conforms, readings
from portbench.gen import vp_synth
from portbench.reference import wiring

MAX_RESTARTS = 64


def write_xml(path: str, settings: dict) -> None:
    """The settings as a reference-format XML config (lists as
    ``<value>`` children)."""
    root: dict = {}
    for key, v in settings.items():
        node = root
        for part in key.split("."):
            node = node.setdefault(part, {})
        node[None] = v

    def emit(node) -> str:
        out = ""
        for k, child in node.items():
            if k is None:
                continue
            v = child.get(None)
            if isinstance(v, list):
                body = "".join(f"<value>{x!r}</value>" for x in v)
            elif v is not None:
                body = repr(v)
            else:
                body = ""
            out += f"<{k}>{body}{emit(child)}</{k}>"
        return out

    with open(path, "w") as f:
        f.write(f"<config>{emit(root)}</config>\n")


class Driver:
    def __init__(self, cfg: dict, index: int, seed: int, device,
                 samples: set):
        from rfs_slam_tpu_torch.apps import _vp_common
        from rfs_slam_tpu_torch.apps import rbphdslam_victoriapark as app
        from rfs_slam_tpu_torch.io import victoria_park as vp_io
        from rfs_slam_tpu_torch.io.xmlconfig import XmlConfig

        self.cfg, self.device, self.vpc = cfg, device, _vp_common
        stream_seed, self.clutter_seed, *self.gen_seeds = run_seeds(
            seed, index, 2 + MAX_RESTARTS)
        x, a = cfg["xml"], cfg["app"]
        self.settings = {**x, **{f"app.{k}": v for k, v in a.items()}}
        self.dir = tempfile.mkdtemp(prefix="portbench-vp-")
        self.n_frames = cfg["stream"]["frames"]
        vp_synth.write(self.dir, seed=stream_seed, n_frames=self.n_frames)
        xml = os.path.join(self.dir, "config.xml")
        write_xml(xml, x)
        xcfg = XmlConfig(xml)
        self.filt, self.icov, ack = app.build(
            xcfg, z_capacity=a["z_capacity"], map_capacity=a["map_capacity"],
            z_dp_max=a["z_dp_max"], device=device)
        self.ref, self.ref_icov = wiring.vp_models(self.settings, device)
        conforms(self.filt, self.ref)
        if not torch.equal(self.icov.cpu(), self.ref_icov.cpu()):
            raise RuntimeError("the program's input covariance departs from "
                               "the configuration")
        self.frames = vp_io.load(self.dir, scale_ur=x["process.ur_scale"],
                                 z_capacity=a["z_capacity"], ackerman=ack)
        self.gen = torch.Generator(device=device)
        self.step = _vp_common.make_frame_step(
            self.filt, app.step_frame, self.frames, self.gen, self.icov,
            artificial_clutter=x["measurements.addedClutter"],
            clutter_seed=self.clutter_seed)
        self.sampler = Sampler(samples)

    def _outputs(self, state):
        return self.vpc.frame_outputs(state, torch.exp(state.particles.log_w))

    def _init(self):
        return self.filt.init_state(torch.zeros(3, device=self.device), dz=3,
                                    d=3)

    # ---------------------------------------------------------------- run
    def warm(self) -> None:
        """Frames from the stream's start and from its middle through the
        chunked loop with a read-back, on throwaway states."""
        self.gen.manual_seed(1)
        for first in (0, min(150, self.n_frames - 6)):
            def frame_step(state, j, first=first):
                state = self.step(state, first + j)
                return state, self._outputs(state)

            self.vpc.chunked_scan(frame_step, self._init(), self.gen, 6,
                                  ckpt_every=3, progress=False)

    def window(self, tick) -> None:
        """Whole streams back to back through the chunked loop until
        ``tick`` raises; frame ``n`` of the window is the ``n``-th call of
        ``tick``."""
        F = self.n_frames
        chunk = self.cfg["stream"]["chunk"]
        n = 0
        for restart in range(MAX_RESTARTS):
            self.gen.manual_seed(self.gen_seeds[restart])
            self.sampler.before(n, 0, None, self.gen)

            def frame_step(state, j):
                nonlocal n
                state = self.step(state, j)
                outs = self._outputs(state)
                self.sampler.after(n, state)
                if j + 1 < F:
                    self.sampler.before(n + 1, j + 1, state, self.gen)
                n += 1
                tick()
                return state, outs

            self.vpc.chunked_scan(frame_step, self._init(), self.gen, F,
                                  ckpt_every=chunk, progress=False)
        raise RuntimeError("the window outlasted its restarts")

    def release(self) -> None:
        self.step = self.frames = None

    def close(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)

    # --------------------------------------------------------- reference
    def check(self, modes=("sound",)) -> list[dict]:
        """Each kept frame recomputed by the reference from the state
        before it, its inputs (read from the stream's files by the
        reference's own loader) and its draws."""
        inp = wiring.vp_inputs(self.ref, self.dir, self.settings,
                               self.clutter_seed, self.device)
        out = []
        for s in self.sampler.done():
            def ref_step(s=s):
                gen = torch.Generator(device=self.device)
                gen.set_state(s["gen"])
                pre = (wiring.init_vp(self.ref, self.device)
                       if s["pre"] is None else wiring.state_from(s["pre"]))
                return wiring.frame_vp(self.ref, pre, inp, s["k"],
                                       self.ref_icov, gen)

            out.append(dict(step=s["n"], k=s["k"],
                            **readings(ref_step, s["post"], modes)))
        return out
