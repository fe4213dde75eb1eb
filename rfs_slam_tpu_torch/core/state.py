"""SoA state containers for the particle filter, as dataclasses of tensors.

Port of the JAX package's ``core/state.py``.  Landmark means and covariances are
plane-major: ``mean[D, P, M]``, packed symmetric ``cov[T, P, M]``
(:mod:`rfs_slam_tpu_torch.core.planar`).  Containers are immutable by
convention: phases build new ones with :func:`dataclasses.replace`.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from rfs_slam_tpu_torch.core import planar


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

    mean: torch.Tensor
    cov: torch.Tensor
    w: torch.Tensor
    w_prev: torch.Tensor
    alive: torch.Tensor

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
    def capacity(self) -> int:
        return self.w.shape[1]

    @property
    def dim(self) -> int:
        return self.mean.shape[0]

    def count(self) -> torch.Tensor:
        return self.alive.sum(dim=-1)

    def gather_p(self, ancestors: torch.Tensor) -> "GMState":
        """Gather along the particle axis (resampling map copy)."""
        return GMState(
            mean=self.mean.index_select(1, ancestors),
            cov=self.cov.index_select(1, ancestors),
            w=self.w.index_select(0, ancestors),
            w_prev=self.w_prev.index_select(0, ancestors),
            alive=self.alive.index_select(0, ancestors),
        )


@dataclasses.dataclass(frozen=True)
class BirthCandidates:
    """Birth-candidate list (RBPHDFilter.hpp:171-178): mean [D, P, C],
    cov [T, P, C], n_support / n_checks [P, C] int32, alive [P, C] bool."""

    mean: torch.Tensor
    cov: torch.Tensor
    n_support: torch.Tensor
    n_checks: torch.Tensor
    alive: torch.Tensor

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

    def gather_p(self, ancestors: torch.Tensor) -> "BirthCandidates":
        return BirthCandidates(
            mean=self.mean.index_select(1, ancestors),
            cov=self.cov.index_select(1, ancestors),
            n_support=self.n_support.index_select(0, ancestors),
            n_checks=self.n_checks.index_select(0, ancestors),
            alive=self.alive.index_select(0, ancestors),
        )


@dataclasses.dataclass(frozen=True)
class ParticleState:
    """pose [P, 3], log_w [P], parent [P] int64 (ancestor of the last
    resample).  Randomness comes from the caller, so no key is carried."""

    pose: torch.Tensor
    log_w: torch.Tensor
    parent: torch.Tensor

    @classmethod
    def init(cls, n_particles: int, pose0: torch.Tensor,
             n_live: int | None = None) -> "ParticleState":
        """``n_particles`` copies of ``pose0``.  With ``n_live`` (the
        MH-FastSLAM grow mode, FastSLAM.hpp:335), only the first
        ``n_live`` slots start live, at weight ``1 / n_live``; the others
        carry ``-inf``."""
        log_w = torch.zeros((n_particles,), dtype=pose0.dtype,
                            device=pose0.device)
        if n_live is not None and n_live != n_particles:
            live = torch.arange(n_particles, device=pose0.device) < n_live
            log_w = torch.where(live, -math.log(float(n_live)),
                                float("-inf")).to(pose0.dtype)
        return cls(
            pose=pose0.expand(n_particles, pose0.shape[-1]).contiguous(),
            log_w=log_w,
            parent=torch.arange(n_particles, device=pose0.device),
        )
