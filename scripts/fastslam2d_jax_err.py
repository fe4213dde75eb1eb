"""The JAX package's FastSLAM 1.0 / MH-FastSLAM 2-D sim app on the data and
config of ``chip_smoke.py``'s FastSLAM phases: the median best-particle
position error over steps >= 150, per filter key, beside dead reckoning's.
Sets the divergence bounds that ``chip_smoke.py`` holds the port's runs to.

The data is ``sim2d.generate(traj_seed=1, noise_seed=1)`` (3,000 steps);
``--steps`` runs its first N steps, as chip_smoke cuts MH-FastSLAM's depth.
The config is ``rfs_slam_tpu_torch/io/sim2d_xml.py``'s stand-in for
``fastslam2dSim.xml`` / ``mhfastslam2dSim.xml``, wired by the JAX app's
``build_filter_from_xml``.  Runs on the CPU (``JAX_PLATFORMS=cpu``); P is an
argument, since the full width is slow there.  Prints one JSON line per key
and a summary line.

Usage::

    JAX_PLATFORMS=cpu python scripts/fastslam2d_jax_err.py \
        [--kind fastslam|mhfastslam] [--particles 50] [--steps 3000] \
        [--keys 0 1 2]
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from rfs_slam_tpu.apps import fastslam2dsim as app  # noqa: E402
from rfs_slam_tpu.io import sim2d  # noqa: E402
from rfs_slam_tpu.io.xmlconfig import XmlConfig, load_sim2d  # noqa: E402
from rfs_slam_tpu_torch.io import sim2d_xml  # noqa: E402

GT_LOCK_STEPS = 100
ERR_FROM_STEP = 150


def run(filt, sim_cfg, data, key, steps):
    """The JAX app's step (predict, ground-truth lock, update) scanned over
    the first ``steps`` - 1 steps from ``PRNGKey(key)``; returns the best
    particle's pose per step."""
    state = filt.init_state(jax.random.PRNGKey(key), jnp.zeros(3))

    def step(state, inp):
        odo, z, z_mask, gt, lock = inp
        state = filt.predict(state, odo, sim_cfg.dt)
        pose = jnp.where(lock, jnp.broadcast_to(gt, state.particles.pose.shape),
                         state.particles.pose)
        state = state.replace(particles=state.particles.replace(pose=pose))
        state = filt.update(state, z, z_mask)
        return state, state.particles.pose[jnp.argmax(state.particles.log_w)]

    inputs = (jnp.asarray(data.odometry[1:steps], jnp.float32),
              jnp.asarray(data.z[1:steps], jnp.float32),
              jnp.asarray(data.z_mask[1:steps]),
              jnp.asarray(data.gt_pose[1:steps], jnp.float32),
              jnp.arange(1, steps) <= GT_LOCK_STEPS)
    _, best = jax.jit(lambda s, i: jax.lax.scan(step, s, i))(state, inputs)
    return np.asarray(best)


def median_err(poses, gt):
    err = np.linalg.norm(poses[:, :2] - gt[:, :2], axis=1)
    return float(np.median(err[ERR_FROM_STEP:]))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kind", choices=("fastslam", "mhfastslam"),
                    default="fastslam")
    ap.add_argument("--particles", type=int, default=50)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--keys", type=int, nargs="+", default=[0])
    args = ap.parse_args()

    with tempfile.TemporaryDirectory() as d:
        cfg = XmlConfig(sim2d_xml.write_config(os.path.join(d, "cfg.xml"),
                                               args.kind))
    sim_cfg = load_sim2d(cfg)
    data = sim2d.generate(sim_cfg, traj_seed=1, noise_seed=1)
    zc = data.z.shape[1]
    filt = app.build_filter_from_xml(cfg, sim_cfg, z_capacity=max(zc, 4),
                                     n_particles=args.particles)
    gt = data.gt_pose[1:args.steps]
    dr = median_err(data.dr_pose[1:args.steps], gt)
    errs = []
    for key in args.keys:
        t0 = time.time()
        best = run(filt, sim_cfg, data, key, args.steps)
        errs.append(median_err(best, gt))
        print(json.dumps({"kind": args.kind, "key": key,
                          "particles": args.particles, "steps": args.steps,
                          "median_pose_err_m": errs[-1],
                          "dead_reckoning_m": dr,
                          "finite": bool(np.isfinite(best).all()),
                          "wall_s": time.time() - t0}), flush=True)
    print(json.dumps({"kind": args.kind, "particles": args.particles,
                      "steps": args.steps, "nmz": filt.cfg.nmz_capacity,
                      "keys": args.keys, "median_pose_err_m": errs,
                      "max_m": max(errs), "dead_reckoning_m": dr}))


if __name__ == "__main__":
    main()
