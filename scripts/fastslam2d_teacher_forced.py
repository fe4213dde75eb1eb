"""Teacher-forced FastSLAM 1.0 over the whole 2-D sim run on the CPU: at
every step of the JAX package's run, the port starts from JAX's state with
JAX's own draws and is compared with JAX's next state.  A step-level fault
in the port shows as a step whose discrete outputs (ancestors, alive
landmarks, candidate slots, landmarks in view) differ; a float-boundary
flip as an isolated one with tiny float differences before it.

``tests/test_torch_fastslam.py`` does the same over 20 steps; this runs its
stepper (``jax_stepper``, ``step_args``, ``port_step``) over all 2,999
steps of ``chip_smoke.py``'s FastSLAM 1.0 data and config
(``sim2d.generate(traj_seed=1, noise_seed=1)``, the stand-in XML of
``rfs_slam_tpu_torch/io/sim2d_xml.py``) at P=50, which the CPU can afford,
from key 0.  Prints one JSON line per differing step and a summary line.

Usage, from the repository root::

    JAX_PLATFORMS=cpu python scripts/fastslam2d_teacher_forced.py
"""

import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from rfs_slam_tpu.apps import fastslam2dsim as japp  # noqa: E402
from rfs_slam_tpu.io import sim2d  # noqa: E402
from rfs_slam_tpu.io.xmlconfig import XmlConfig, load_sim2d  # noqa: E402
from rfs_slam_tpu_torch import convert  # noqa: E402
from rfs_slam_tpu_torch.io import sim2d_xml  # noqa: E402
from tests.test_torch_fastslam import (  # noqa: E402
    jax_stepper, port_step, step_args)
from tests.torch_parity import CPU  # noqa: E402

PARTICLES = 50
KEY = 0


def main():
    with tempfile.TemporaryDirectory() as d:
        cfg = XmlConfig(sim2d_xml.write_config(os.path.join(d, "cfg.xml"),
                                               "fastslam"))
    sim_cfg = load_sim2d(cfg)
    data = sim2d.generate(sim_cfg, traj_seed=1, noise_seed=1)
    jfilt = japp.build_filter_from_xml(cfg, sim_cfg,
                                       z_capacity=max(data.z.shape[1], 4),
                                       n_particles=PARTICLES)
    filt = convert.filter_from_numpy(jfilt, CPU)
    jstep = jax_stepper(jfilt, sim_cfg.dt)
    jstate = jfilt.init_state(jax.random.PRNGKey(KEY), jnp.zeros(3))
    n_diff, n_steps, worst = 0, 0, 0.0
    t0 = time.time()
    for k in range(1, sim_cfg.timesteps):
        args = step_args(data, k)
        got = port_step(filt, jstate, *args)
        jstate = jstep(jstate, *args)
        n_steps += 1
        diffs = {}
        for name, a, b in (
                ("parent", got.particles.parent, jstate.particles.parent),
                ("alive", got.gm.alive, jstate.gm.alive),
                ("cand_alive", got.cand.alive, jstate.cand.alive),
                ("n_in_fov", got.n_in_fov, jstate.n_in_fov)):
            bad = int((a.numpy() != np.asarray(b)).sum())
            if bad:
                diffs[name] = bad
        lw_a, lw_b = got.particles.log_w.numpy(), np.asarray(
            jstate.particles.log_w)
        fin = np.isfinite(lw_b)
        lw_err = float(np.max(np.abs(lw_a[fin] - lw_b[fin]), initial=0.0))
        alive = np.asarray(jstate.gm.alive) & got.gm.alive.numpy()
        mean_err = float(np.max(np.abs(got.gm.mean.numpy()[:, alive]
                                       - np.asarray(jstate.gm.mean)[:, alive]),
                                initial=0.0))
        worst = max(worst, mean_err)
        if diffs:
            n_diff += 1
            print(json.dumps({"step": k, "differ": diffs,
                              "log_w_max_abs": lw_err,
                              "mean_max_abs": mean_err}), flush=True)
    print(json.dumps({"kind": "fastslam", "particles": PARTICLES,
                      "key": KEY, "steps": n_steps,
                      "steps_with_discrete_differences": n_diff,
                      "mean_max_abs_worst": worst,
                      "wall_s": time.time() - t0}))


if __name__ == "__main__":
    main()
