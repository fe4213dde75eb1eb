"""Process models as batched functions (port of
the JAX package's ``models/motion.py``, the main path's two models).

``Odometry2D.sample`` takes its standard-normal draws as ``noise`` so that
a caller can replay another generator's stream; without it, it draws from
the caller's ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses

import torch

from rfs_slam_tpu_torch.core import gaussian, planar


@dataclasses.dataclass(frozen=True)
class Odometry2D:
    """SE(2) odometry model (reference: ProcessModel_Odometry2D.cpp:41-89).

    ``Q``: [3, 3] additive white-noise covariance (already scaled by dt^2
    and the inflation factor, as the reference apps do).
    """

    Q: torch.Tensor

    def step(self, pose: torch.Tensor, u: torch.Tensor, dt) -> torch.Tensor:
        theta = pose[..., 2]
        c, s = torch.cos(theta), torch.sin(theta)
        dx, dy, dth = u[..., 0], u[..., 1], u[..., 2]
        x = pose[..., 0] + c * dx - s * dy
        y = pose[..., 1] + s * dx + c * dy
        th = gaussian.wrap_angle(theta + dth)
        return torch.stack([x, y, th], dim=-1)

    def sample(self, pose: torch.Tensor, u: torch.Tensor, dt,
               noise: torch.Tensor | None = None,
               gen: torch.Generator | None = None) -> torch.Tensor:
        """Step, then add chol(Q) @ n with n ~ N(0, I) per particle
        (ProcessModel::sample, ProcessModel.hpp:125-150).  ``noise``:
        [..., 3] standard-normal draws; drawn from ``gen`` when None."""
        out = self.step(pose, u, dt)
        if noise is None:
            noise = torch.randn(out.shape, generator=gen, dtype=out.dtype,
                                device=out.device)
        out = out + noise @ gaussian.chol3(self.Q).T
        return torch.cat([out[..., :2], gaussian.wrap_angle(out[..., 2:])],
                         dim=-1)


@dataclasses.dataclass(frozen=True)
class StaticLandmark:
    """Landmark process model: identity mean, covariance grows by ``Q``
    ([D, D], pre-scaled by dt^2; ProcessModel.hpp:195-219)."""

    Q: torch.Tensor

    def static_step_p(self, mean: torch.Tensor, cov: torch.Tensor, dt):
        """Plane-layout step: ``cov[T, ...]`` packed."""
        qp = planar.pack_sym(self.Q)
        return mean, cov + qp.reshape(qp.shape + (1,) * (cov.ndim - 1))
