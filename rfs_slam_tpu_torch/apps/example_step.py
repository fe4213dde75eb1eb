"""The RB-PHD example step: the filter of the JAX package's
``__graft_entry__._build`` and the inputs of its ``_example_inputs``, for the
port (that file imports JAX, so the port keeps its own copy).

The filter is the 2-D range-bearing RB-PHD filter with dt 0.1, the gates
of ``bench.py``, ``new_capacity`` 32, ``eval_capacity`` 8 and ``z_dp_max`` 6
unless the caller says otherwise; the inputs seed every particle's map
with a ring of ``map_capacity // 2`` landmarks at 1.5 m around the origin,
so one step exercises every phase (births, the map update, the merge of a
crowded ring, pruning, resampling).  The large-map tools
(``parallel/map_overflow_demo.py``, ``parallel/map_shard_bench.py``) run
this step at thousands of slots.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from rfs_slam_tpu_torch.filters.rbphd import (RBPHDConfig, RBPHDFilter,
                                              RBPHDState)
from rfs_slam_tpu_torch.models.measurement import RangeBearing
from rfs_slam_tpu_torch.models.motion import Odometry2D, StaticLandmark
from rfs_slam_tpu_torch.ops.ekf import InnovationGates

DT = 0.1
RING_RADIUS = 1.5


def build(n_particles: int, map_capacity: int, z_capacity: int,
          device: torch.device, new_capacity: int = 32,
          eval_capacity: int = 8, z_dp_max: int = 6) -> RBPHDFilter:
    """``__graft_entry__._build``'s filter on ``device``; the noise
    matrices are scaled in float64 and rounded once, as numpy constants
    reach the JAX filter."""
    def f32(a):
        return torch.tensor(a, dtype=torch.float32, device=device)

    motion = Odometry2D(Q=f32(np.eye(3) * (0.002 * 1.5 * DT * DT)))
    lmk = StaticLandmark(Q=f32(np.eye(2) * (0.0002 * DT * DT)))
    meas = RangeBearing(R=f32(np.diag([0.0005, 0.00005]) * 10.0),
                        pd_const=0.99, clutter=1e-4, r_max=2.5, r_min=0.5,
                        r_buf=0.05)
    gates = InnovationGates.range_bearing(range_t=1.0, bearing_t=0.2)
    cfg = RBPHDConfig(
        n_particles=n_particles, map_capacity=map_capacity,
        z_capacity=z_capacity, new_capacity=new_capacity,
        birth_capacity=8, eval_capacity=eval_capacity, z_dp_max=z_dp_max,
        birth_gaussian_weight=0.01, new_gaussian_md_threshold=3.0,
        merge_threshold=0.5, merge_inflation=1.5, prune_threshold=0.01,
        min_updates_before_resample=2, ess_threshold=n_particles / 2.0)
    return RBPHDFilter(motion, lmk, meas, gates, cfg)


def example_inputs(filt: RBPHDFilter, device: torch.device):
    """``(state, odo, z, z_mask)``: the initial state at the origin with
    the ring in the first ``map_capacity // 2`` slots of every particle
    (weight 0.8, covariance 0.01 I), ``z_capacity`` measurements on a line
    in (range, bearing) of which the last two are masked, and the
    odometry ``(0.03, 0, 0.01)``."""
    cfg = filt.cfg
    state = filt.init_state(torch.zeros(3, device=device))
    m = cfg.map_capacity // 2
    # jnp.linspace(0, 2 pi, m, endpoint=False) as JAX writes it in float32
    ang = torch.arange(m, dtype=torch.float32, device=device) / m * (
        torch.tensor(2 * math.pi, dtype=torch.float32, device=device))
    gm = state.gm
    mean, cov, w, alive = (gm.mean.clone(), gm.cov.clone(), gm.w.clone(),
                           gm.alive.clone())
    mean[0, :, :m] = RING_RADIUS * torch.cos(ang)
    mean[1, :, :m] = RING_RADIUS * torch.sin(ang)
    cov[:, :, :m] = torch.tensor([0.01, 0.0, 0.01], device=device)[:, None,
                                                                    None]
    w[:, :m] = 0.8
    alive[:, :m] = True
    state = dataclasses.replace(state, gm=dataclasses.replace(
        gm, mean=mean, cov=cov, w=w, alive=alive))
    zc = cfg.z_capacity
    z = torch.stack([torch.linspace(1.4, 1.6, zc, device=device),
                     torch.linspace(-0.5, 0.5, zc, device=device)], dim=-1)
    z_mask = torch.arange(zc, device=device) < zc - 2
    odo = torch.tensor([0.03, 0.0, 0.01], device=device)
    return state, odo, z, z_mask


def step(filt: RBPHDFilter, state: RBPHDState, odo, z, z_mask,
         gen: torch.Generator, mesh=None) -> RBPHDState:
    """One predict + update with draws from ``gen`` (the motion noise,
    then the resampling offset), on ``mesh``'s block when given: every
    rank draws the whole motion noise and keeps its block, as
    ``sim2d_common.steps`` does."""
    noise = None if mesh is None else mesh.randn_block(gen, 3)
    state = filt.predict(state, odo, DT, gen=gen, noise=noise, mesh=mesh)
    return filt.update(state, z, z_mask, gen=gen, has_z=True, mesh=mesh)
