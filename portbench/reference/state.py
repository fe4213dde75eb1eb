"""SoA state containers for the particle filter, as dataclasses of tensors.

Frozen from the port's ``core/state.py``.  Landmark means and covariances
are plane-major: ``mean[D, P, M]``, packed symmetric ``cov[T, P, M]``
(``planar.py`` here).  Containers are immutable by convention: phases
build new ones with :func:`dataclasses.replace`.

Each per-particle field declares its particle axis (:func:`rows`: 0 for
``[P, ...]``, 1 for the plane-major ``[D|T, P, M]``); a field without one
is the same for every particle.  :func:`map_rows` applies a function to
the per-particle fields of a state.
"""

from __future__ import annotations

import dataclasses

import torch


PARTICLE_AXIS_KEY = "particle_axis"


def rows(axis: int = 0):
    """A dataclass field whose axis ``axis`` is the particle axis."""
    return dataclasses.field(metadata={PARTICLE_AXIS_KEY: axis})


def map_rows(fn, obj):
    """``obj`` with every per-particle tensor ``x`` replaced by ``fn(x,
    axis)``, the other fields kept.  ``obj`` is one of the state
    dataclasses (nested ones are walked) or a dict of them and of tensors
    whose leading axis is the particle axis."""
    if isinstance(obj, dict):
        return {k: map_rows(fn, v) if dataclasses.is_dataclass(v)
                else fn(v, 0) for k, v in obj.items()}
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            changes[f.name] = map_rows(fn, v)
        elif f.metadata.get(PARTICLE_AXIS_KEY) is not None:
            changes[f.name] = fn(v, f.metadata[PARTICLE_AXIS_KEY])
    return dataclasses.replace(obj, **changes)


def _eye_planes(n_particles, capacity, dim, device, dtype):
    # filled on the device: a host tensor copied there would wait for the
    # device's queue (a run's init_state sits inside its step loop)
    return torch.stack([torch.full((n_particles, capacity),
                                   1.0 if i == j else 0.0, dtype=dtype,
                                   device=device)
                        for i in range(dim) for j in range(i, dim)])


@dataclasses.dataclass(frozen=True)
class GMState:
    """Per-particle Gaussian-mixture map, padded to capacity M.

    mean [D, P, M], cov [T, P, M] packed, w / w_prev [P, M], alive [P, M] bool.
    """

    mean: torch.Tensor = rows(1)
    cov: torch.Tensor = rows(1)
    w: torch.Tensor = rows(0)
    w_prev: torch.Tensor = rows(0)
    alive: torch.Tensor = rows(0)

    @classmethod
    def empty(cls, n_particles: int, capacity: int, dim: int,
              device: torch.device, dtype=torch.float32) -> "GMState":
        z = torch.zeros((n_particles, capacity), dtype=dtype, device=device)
        return cls(
            mean=torch.zeros((dim, n_particles, capacity), dtype=dtype,
                             device=device),
            cov=_eye_planes(n_particles, capacity, dim, device, dtype),
            w=z, w_prev=z.clone(),
            alive=torch.zeros((n_particles, capacity), dtype=torch.bool,
                              device=device),
        )

    @property
    def n_particles(self) -> int:
        return self.w.shape[0]

    @property
    def capacity(self) -> int:
        return self.w.shape[1]

    @property
    def dim(self) -> int:
        return self.mean.shape[0]


@dataclasses.dataclass(frozen=True)
class BirthCandidates:
    """Birth-candidate list (RBPHDFilter.hpp:171-178): mean [D, P, C],
    cov [T, P, C], n_support / n_checks [P, C] int32, alive [P, C] bool."""

    mean: torch.Tensor = rows(1)
    cov: torch.Tensor = rows(1)
    n_support: torch.Tensor = rows(0)
    n_checks: torch.Tensor = rows(0)
    alive: torch.Tensor = rows(0)

    @classmethod
    def empty(cls, n_particles: int, capacity: int, dim: int,
              device: torch.device, dtype=torch.float32) -> "BirthCandidates":
        zi = torch.zeros((n_particles, capacity), dtype=torch.int32,
                         device=device)
        return cls(
            mean=torch.zeros((dim, n_particles, capacity), dtype=dtype,
                             device=device),
            cov=_eye_planes(n_particles, capacity, dim, device, dtype),
            n_support=zi, n_checks=zi.clone(),
            alive=torch.zeros((n_particles, capacity), dtype=torch.bool,
                              device=device),
        )

    @property
    def capacity(self) -> int:
        return self.alive.shape[1]


@dataclasses.dataclass(frozen=True)
class ParticleState:
    """pose [P, 3], log_w [P], parent [P] int64 (ancestor of the last
    resample).  Randomness comes from the caller, so no key is carried."""

    pose: torch.Tensor = rows(0)
    log_w: torch.Tensor = rows(0)
    parent: torch.Tensor = rows(0)

    @classmethod
    def init(cls, n_particles: int, pose0: torch.Tensor) -> "ParticleState":
        """``n_particles`` copies of ``pose0``."""
        log_w = torch.zeros((n_particles,), dtype=pose0.dtype,
                            device=pose0.device)
        return cls(
            pose=pose0.expand(n_particles, pose0.shape[-1]).contiguous(),
            log_w=log_w,
            parent=torch.arange(n_particles, device=pose0.device),
        )

    @property
    def n_particles(self) -> int:
        return self.pose.shape[0]
