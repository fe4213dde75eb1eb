"""Faults planted under a run's timed path, for the tests and the
readings that show the comparison catches them: each takes a driver and
breaks its filter's update in this process.  (One card: no exchange
between chips to leave out.)"""

from __future__ import annotations

import dataclasses

import torch

PARTICLE_AXIS_KEY = "particle_axis"


def _wrap_update(drv, after):
    orig = drv.filt.update

    def update(state, *a, **k):
        return after(state, orig(state, *a, **k))

    drv.filt.update = update


def unchanged(drv) -> None:
    """A step that returns its state unchanged: the update hands back the
    state it was given."""
    _wrap_update(drv, lambda state, out: state)


def _half(out, before):
    """``out`` with the second half of its particles' rows taken from
    ``before``."""
    changes = {}
    for f in dataclasses.fields(out):
        a, b = getattr(out, f.name), getattr(before, f.name)
        if dataclasses.is_dataclass(a):
            changes[f.name] = _half(a, b)
            continue
        axis = f.metadata.get(PARTICLE_AXIS_KEY)
        if axis is None or a.shape != b.shape:
            continue
        P = a.shape[axis]
        keep = torch.arange(P, device=a.device) < P // 2
        shape = [1] * a.dim()
        shape[axis] = P
        changes[f.name] = torch.where(keep.view(shape), a, b)
    return dataclasses.replace(out, **changes)


def half_batch(drv) -> None:
    """Half of the batch left out: the second half of the particles keep
    the state they entered the update with."""
    _wrap_update(drv, lambda state, out: _half(out, state))


def altered(drv) -> None:
    """An answer altered where it is produced: the first particle's x
    moved by 10 cm after each update."""
    def after(state, out):
        pose = out.particles.pose.clone()
        pose[0, 0] += 0.1
        return dataclasses.replace(out, particles=dataclasses.replace(
            out.particles, pose=pose))

    _wrap_update(drv, after)


def resample_unweighted(drv) -> None:
    """A resampling that ignores the weights: where the filter resamples,
    every particle is its own ancestor (the weights still reset)."""
    from rfs_slam_tpu_torch.ops import resample

    def identity(u0, log_w, n):
        return torch.arange(n, device=log_w.device)

    orig = drv.filt._resample_phase

    def phase(*a, **k):
        saved = resample.systematic_ancestors
        resample.systematic_ancestors = identity
        try:
            return orig(*a, **k)
        finally:
            resample.systematic_ancestors = saved

    drv.filt._resample_phase = phase


def prune_tenfold(drv) -> None:
    """A prune at ten times the configured threshold."""
    cfg = drv.filt.cfg
    drv.filt.cfg = dataclasses.replace(
        cfg, prune_threshold=10 * cfg.prune_threshold)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered": altered, "resample_unweighted": resample_unweighted,
          "prune_tenfold": prune_tenfold}
