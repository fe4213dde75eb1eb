"""Process models as batched functions (port of the JAX package's
``models/motion.py``: the 2-D simulation's Odometry2D, the Victoria
Park vehicle's Ackerman2D, Odometry1D, and the static landmark model).

``sample`` adds input and/or additive white noise like
``ProcessModel::sample`` (ProcessModel.hpp:125-150).  The standard-normal
draws are injected (``noise`` [..., 3] for the model noise, ``input_noise``
[..., DU] for the input noise) so that a caller can replay another
generator's stream; without them they come from the caller's
``torch.Generator``.  ``use_input_noise`` is a host bool: the Victoria Park
frame loop reads its per-substep flag from host data.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import gaussian, planar


def _sample_input(pose, u, use_input_noise, input_cov, input_noise, gen):
    """The input broadcast over the particles, sampled from N(u, U) when
    ``use_input_noise`` (ProcessModel.hpp:133-140)."""
    u = u.expand(pose.shape[:-1] + u.shape[-1:])
    if input_cov is None or not use_input_noise:
        return u
    return gaussian.sample(u, input_cov, input_noise, gen)


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
               gen: torch.Generator | None = None,
               use_model_noise: bool = True, use_input_noise: bool = False,
               input_cov: torch.Tensor | None = None,
               input_noise: torch.Tensor | None = None) -> torch.Tensor:
        """Step, then add chol(Q) @ n with n ~ N(0, I) per particle, the
        angle wrapped after."""
        u = _sample_input(pose, u, use_input_noise, input_cov, input_noise,
                          gen)
        out = self.step(pose, u, dt)
        if not use_model_noise:
            return out
        out = gaussian.sample(out, self.Q, noise, gen)
        return torch.cat([out[..., :2], gaussian.wrap_angle(out[..., 2:])],
                         dim=-1)


@dataclasses.dataclass(frozen=True)
class Odometry1D:
    """1-D odometry model (reference: ProcessModel_Odometry1D.cpp): the
    pose moves by the input; ``Q`` [1, 1]."""

    Q: torch.Tensor

    def step(self, pose: torch.Tensor, u: torch.Tensor, dt) -> torch.Tensor:
        return pose + u

    def sample(self, pose: torch.Tensor, u: torch.Tensor, dt,
               noise: torch.Tensor | None = None,
               gen: torch.Generator | None = None,
               use_model_noise: bool = True, use_input_noise: bool = False,
               input_cov: torch.Tensor | None = None,
               input_noise: torch.Tensor | None = None) -> torch.Tensor:
        u = _sample_input(pose, u, use_input_noise, input_cov, input_noise,
                          gen)
        out = self.step(pose, u, dt)
        if not use_model_noise:
            return out
        return gaussian.sample(out, self.Q, noise, gen)


@dataclasses.dataclass(frozen=True)
class Ackerman2D:
    """Ackerman-steered vehicle (reference: ProcessModel_Ackerman2D.cpp:49-77).

    Input ``[v, r]``: rear-wheel speed and steering angle.  Geometry of the
    Victoria Park vehicle: rear-axle-to-encoder offset ``h``, wheelbase
    ``l``, sensor offset ``(dx, dy)``; the pose is the sensor point's.
    """

    Q: torch.Tensor
    h: float = 0.76
    l: float = 2.83
    dx: float = 0.5
    dy: float = 0.5

    def step(self, pose: torch.Tensor, u: torch.Tensor, dt) -> torch.Tensor:
        v, r = u[..., 0], u[..., 1]
        theta = pose[..., 2]
        c, s = torch.cos(theta), torch.sin(theta)
        tan_r = torch.tan(r)
        v = v / (1.0 - tan_r * self.h / self.l)
        dxs = dt * (v * c - v / self.l * tan_r * (self.dx * s + self.dy * c))
        dys = dt * (v * s + v / self.l * tan_r * (self.dx * c - self.dy * s))
        th = theta + dt * v / self.l * tan_r
        # single-branch wrap, exactly as the reference (+-2 pi once)
        th = torch.where(th > np.pi, th - 2 * np.pi, th)
        th = torch.where(th < -np.pi, th + 2 * np.pi, th)
        return torch.stack([pose[..., 0] + dxs, pose[..., 1] + dys, th],
                           dim=-1)

    def sample(self, pose: torch.Tensor, u: torch.Tensor, dt,
               noise: torch.Tensor | None = None,
               gen: torch.Generator | None = None,
               use_model_noise: bool = True, use_input_noise: bool = False,
               input_cov: torch.Tensor | None = None,
               input_noise: torch.Tensor | None = None) -> torch.Tensor:
        u = _sample_input(pose, u, use_input_noise, input_cov, input_noise,
                          gen)
        out = self.step(pose, u, dt)
        if not use_model_noise:
            return out
        return gaussian.sample(out, self.Q, noise, gen)


@dataclasses.dataclass(frozen=True)
class StaticLandmark:
    """Landmark process model: identity mean, covariance grows by ``Q``
    ([D, D]; ProcessModel.hpp:195-219).  The sim apps pre-scale ``Q`` by
    dt^2; ``per_dt2`` scales it at step time instead (the Victoria Park
    wiring, rbphdslam_VictoriaPark.cpp:508-510)."""

    Q: torch.Tensor
    per_dt2: bool = False

    def _q(self, dt) -> torch.Tensor:
        """Q for a step of ``dt``; dt^2 is formed in float32, as the JAX
        package forms it."""
        if not self.per_dt2:
            return self.Q
        d = np.float32(dt)
        return self.Q * float(d * d)

    def static_step(self, mean: torch.Tensor, cov: torch.Tensor, dt):
        """Dense step: ``cov [..., D, D]`` grows by Q."""
        return mean, cov + self._q(dt)

    def static_step_p(self, mean: torch.Tensor, cov: torch.Tensor, dt):
        """Plane-layout step: ``cov[T, ...]`` packed."""
        qp = planar.pack_sym(self._q(dt))
        return mean, cov + qp.reshape(qp.shape + (1,) * (cov.ndim - 1))
