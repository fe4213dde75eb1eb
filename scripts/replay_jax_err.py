"""The JAX package's RB-PHD filter on the ``native/bl_dump`` replay, per
filter key: the median best-particle position error over steps >= 150.

The reference side of ``scripts/replay_seeds_torch.py``: the same dump, the
filter of ``bench.py:52-81`` (P=200, M=128, Zc=40; built here, since
importing ``bench`` turns on its compile cache), the ground-truth lock for
steps <= 100, the JAX filter unchanged, ``PRNGKey(key)`` per key.  Runs on
the CPU (``JAX_PLATFORMS=cpu``, XLA's paths).  Prints one JSON line per key
and a summary line.

Usage::

    JAX_PLATFORMS=cpu python scripts/replay_jax_err.py [--keys 0 1 2] \
        [--steps 3000]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from rfs_slam_tpu.filters.rbphd import RBPHDConfig, RBPHDFilter  # noqa: E402
from rfs_slam_tpu.io import sim2d  # noqa: E402
from rfs_slam_tpu.models.motion import Odometry2D, StaticLandmark  # noqa: E402
from rfs_slam_tpu.models.measurement import RangeBearing  # noqa: E402
from rfs_slam_tpu.ops.ekf import InnovationGates  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Z_CAPACITY = 40
GT_LOCK_STEPS = 100
ERR_FROM_STEP = 150


def build_filter():
    """``bench.build``'s filter (the rbphdslam2dSim.xml defaults)."""
    c = sim2d.Sim2DConfig()
    dt = c.dt
    motion = Odometry2D(Q=np.diag([c.vardx, c.vardy, c.vardz])
                        * (1.5 * dt * dt))
    lmk = StaticLandmark(Q=np.diag([c.varlmx, c.varlmy]) * dt * dt)
    meas = RangeBearing(R=np.diag([c.varzr, c.varzb]) * 10.0,
                        pd_const=c.pd, clutter=c.clutter, r_max=c.range_max,
                        r_min=c.range_min, r_buf=c.range_buffer)
    gates = InnovationGates.range_bearing(range_t=1.0, bearing_t=0.2)
    cfg = RBPHDConfig(
        n_particles=200, map_capacity=128, z_capacity=Z_CAPACITY,
        new_capacity=48, new_per_z=8, birth_capacity=16, eval_capacity=15,
        z_dp_max=10, birth_gaussian_weight=0.01,
        new_gaussian_md_threshold=3.0, eval_pt_min_weight=0.75,
        weighting_md_threshold=3.0, merge_threshold=0.5, merge_inflation=1.5,
        prune_threshold=0.01, min_updates_before_resample=2,
        ess_threshold=100.0)
    return RBPHDFilter(motion, lmk, meas, gates, cfg), dt


def load_dump(steps):
    """``bench.load_identical_data``'s inputs, cut to ``steps``."""
    d = os.path.join(ROOT, "native", "bl_dump")
    go = np.loadtxt(os.path.join(d, "gt_odo.txt"))[:steps]
    gt, odo = go[:, :3], go[:, 3:]
    z = np.zeros((steps, Z_CAPACITY, 2), np.float32)
    z_mask = np.zeros((steps, Z_CAPACITY), bool)
    counts = np.zeros(steps, np.int32)
    for k, r, b in np.loadtxt(os.path.join(d, "z.txt")):
        k = int(k)
        if k < steps and counts[k] < Z_CAPACITY:
            z[k, counts[k]] = (r, b)
            z_mask[k, counts[k]] = True
            counts[k] += 1
    inputs = (jnp.asarray(odo[1:], jnp.float32), jnp.asarray(z[1:]),
              jnp.asarray(z_mask[1:]), jnp.asarray(gt[1:], jnp.float32),
              jnp.arange(1, steps) <= GT_LOCK_STEPS)
    return gt, inputs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--keys", type=int, nargs="+", default=[0])
    ap.add_argument("--steps", type=int, default=3000)
    args = ap.parse_args()

    filt, dt = build_filter()
    gt, inputs = load_dump(args.steps)

    def step(state, inp):
        odo, z, z_mask, g, lock = inp
        state = filt.predict(state, odo, dt)
        pose = jnp.where(lock, jnp.broadcast_to(g, state.particles.pose.shape),
                         state.particles.pose)
        state = state.replace(particles=state.particles.replace(pose=pose))
        state = filt.update(state, z, z_mask)
        return state, state.particles.pose[jnp.argmax(state.particles.log_w)]

    run = jax.jit(lambda s, i: jax.lax.scan(step, s, i))
    errs = []
    for key in args.keys:
        t0 = time.time()
        _, best = run(filt.init_state(jax.random.PRNGKey(key), jnp.zeros(3)),
                      inputs)
        best = np.asarray(best)
        err = np.linalg.norm(best[:, :2] - gt[1:, :2], axis=1)
        errs.append(float(np.median(err[ERR_FROM_STEP:])))
        print(json.dumps({"key": key, "steps": args.steps,
                          "median_pose_err_m": errs[-1],
                          "finite": bool(np.isfinite(best).all()),
                          "wall_s": time.time() - t0}), flush=True)
    print(json.dumps({"keys": args.keys, "steps": args.steps,
                      "median_pose_err_m": errs,
                      "median_m": float(np.median(errs))}))


if __name__ == "__main__":
    main()
