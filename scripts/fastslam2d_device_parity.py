"""The port's FastSLAM on the card against the same port on the CPU, step
by step: at every step of the card's run, the CPU path (the plain twins)
starts from the card's state with the same draws and is compared with the
card's next state.  Counts the steps whose discrete outputs (ancestors,
alive landmarks, candidate slots, landmarks in view) differ, and the
largest float difference on landmarks alive in both.

Data and config are those of ``chip_smoke.py``'s FastSLAM 1.0 phase
(``sim2d.generate(traj_seed=1, noise_seed=1)``, the stand-in XML of
``io/sim2d_xml.py``, P=200), over its first 1,200 steps, with the draws of
a CPU generator seeded 0.  Prints one JSON line per differing step and a
summary line.

Usage, from the repository root on a machine with the card::

    python3 scripts/fastslam2d_device_parity.py
"""

import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rfs_slam_tpu_torch import convert  # noqa: E402
from rfs_slam_tpu_torch.apps import fastslam2dsim as app  # noqa: E402
from rfs_slam_tpu_torch.apps import sim2d_common as loop  # noqa: E402
from rfs_slam_tpu_torch.filters.fastslam import FastSLAMState  # noqa: E402
from rfs_slam_tpu_torch.io import sim2d, sim2d_xml  # noqa: E402
from rfs_slam_tpu_torch.io.xmlconfig import XmlConfig, load_sim2d  # noqa: E402

CPU = torch.device("cpu")
STEPS = 1200


def main():
    torch.set_num_threads(1)
    dev = loop.device_for("cuda")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    cfg = XmlConfig(sim2d_xml.write_config(
        os.path.join(ROOT, "build", "fastslam2dSim.xml"), "fastslam"))
    sim_cfg = load_sim2d(cfg)
    data = sim2d.generate(sim_cfg, traj_seed=1, noise_seed=1)
    zc = max(data.z.shape[1], 4)
    filters = [app.build_filter_from_xml(cfg, sim_cfg, z_capacity=zc,
                                         device=d) for d in (dev, CPU)]
    odo, z, zm, gt, lock = loop.sim_inputs(data, steps=STEPS, z_capacity=zc)
    gen = torch.Generator().manual_seed(0)
    P = filters[0].p_cap
    state = filters[0].init_state(torch.zeros(3, device=dev))
    n_diff, worst = 0, 0.0
    t0 = time.time()
    for k in range(len(odo)):
        noise = torch.randn((P, 3), generator=gen)
        u0 = torch.rand((), generator=gen)
        out = []
        for f, d in zip(filters, (dev, CPU)):
            s = convert.from_numpy(FastSLAMState, convert.to_numpy(state), d)

            def put(a, dtype=torch.float32):
                return torch.as_tensor(np.asarray(a), dtype=dtype, device=d)

            s = f.predict(s, put(odo[k]), sim_cfg.dt, noise=noise.to(d))
            if lock[k]:
                s = dataclasses.replace(
                    s, particles=dataclasses.replace(
                        s.particles,
                        pose=put(gt[k]).expand(P, 3).contiguous()))
            out.append(f.update(s, put(z[k]), put(zm[k], torch.bool),
                                u0=u0.to(d), has_z=bool(zm[k].any())))
        state = out[0]
        a, b = (convert.to_numpy(o) for o in out)
        diffs = {}
        for name, x, y in (
                ("parent", a["particles"]["parent"], b["particles"]["parent"]),
                ("alive", a["gm"]["alive"], b["gm"]["alive"]),
                ("cand_alive", a["cand"]["alive"], b["cand"]["alive"]),
                ("n_in_fov", a["n_in_fov"], b["n_in_fov"])):
            bad = int((x != y).sum())
            if bad:
                diffs[name] = bad
        both = a["gm"]["alive"] & b["gm"]["alive"]
        err = float(np.max(np.abs(a["gm"]["mean"][:, both]
                                  - b["gm"]["mean"][:, both]), initial=0.0))
        worst = max(worst, err)
        if diffs:
            n_diff += 1
            print(json.dumps({"step": k + 1, "differ": diffs,
                              "mean_max_abs": err}), flush=True)
    print(json.dumps({"kind": "fastslam", "steps": len(odo),
                      "particles": filters[0].cfg.n_particles,
                      "steps_with_discrete_differences": n_diff,
                      "mean_max_abs_worst": worst,
                      "wall_s": time.time() - t0}))


if __name__ == "__main__":
    main()
