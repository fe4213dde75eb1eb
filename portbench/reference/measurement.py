"""Measurement models as batched functions (port of the JAX package's
``models/measurement.py``): range-bearing, robot-frame x-y and 1-D range
(MeasurementModel_RngBrg.cpp, MeasurementModel_XY.cpp,
MeasurementModel_Rng1D.cpp).

Each model has the plane-layout API of the filters' hot path (``measure_p``,
``inverse_p``, ``pd_p``: landmark planes ``mean[D, ...]``, packed
``cov[T, ...]``; see :mod:`rfs_slam_tpu_torch.core.planar`) and the dense
API (``measure``, ``inverse``, ``pd``: ``(..., D)`` means and
``(..., D, D)`` covariances).  Poses ``(..., 3)`` (``(..., 1)`` for 1-D)
broadcast against the landmarks; callers align axes.  Particle poses carry
no covariance in the filters, so S = H_m Sigma_m H_m^T + R
(MeasurementModel_RngBrg.cpp:96-103).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from . import gaussian, planar


class MeasurePrediction(NamedTuple):
    z: torch.Tensor       # (..., DZ)   expected measurement
    S: torch.Tensor       # (..., DZ, DZ) innovation covariance (lmk term + R)
    H_lmk: torch.Tensor   # (..., DZ, D)
    H_pose: torch.Tensor  # (..., DZ, 3)
    valid: torch.Tensor   # (...,) bool: the reference's bool return value


class PlanarPrediction(NamedTuple):
    z: tuple              # DZ planes
    S: torch.Tensor       # [TZ, ...] packed innovation covariance planes
    H: list               # DZ x D nested list of H_lmk planes
    valid: torch.Tensor   # bool plane


def _dense_S(R, z, H, lm_cov):
    """R broadcast over the batch of ``z``, plus H lm_cov H^T."""
    S = R.expand(z.shape + (R.shape[-1],))
    if lm_cov is not None:
        S = S + H @ lm_cov @ H.transpose(-1, -2)
    return S


def _packed_R(R, shape):
    """The packed planes of R, each broadcast to ``shape``."""
    d = R.shape[-1]
    return torch.stack([R[i, j].expand(shape)
                        for i in range(d) for j in range(i, d)])


@dataclasses.dataclass(frozen=True)
class _Annulus:
    """Detection inside the sensing annulus [r_min, r_max], the buffer zone
    of width ``r_buf`` on both of its edges (MeasurementModel_RngBrg.cpp:
    138-167), uniform clutter."""

    R: torch.Tensor
    pd_const: float = 0.95
    clutter: float = 0.1
    r_max: float = 5.0
    r_min: float = 0.3
    r_buf: float = 0.25

    def _in_range(self, r):
        return (r <= self.r_max) & (r >= self.r_min)

    def _pd_of_range(self, r):
        """(pd, close-to-limit) of landmarks at range ``r``."""
        inside = self._in_range(r)
        pd = torch.where(inside, self.pd_const, 0.0).to(r.dtype)
        near_inner = inside & ((r >= self.r_max - self.r_buf)
                               | (r <= self.r_min + self.r_buf))
        near_outer = (~inside) & ((r <= self.r_max + self.r_buf)
                                  & (r >= self.r_min - self.r_buf))
        return pd, near_inner | near_outer

    def clutter_intensity(self, z=None, n_z=None) -> float:
        return self.clutter


class _Planar2D(_Annulus):
    """Range of a 2-D landmark from the pose, plane and dense layouts."""

    def pd_p(self, pose, mean, cov=None):
        """Returns (pd plane, close-to-limit plane)."""
        dx = mean[0] - pose[..., 0]
        dy = mean[1] - pose[..., 1]
        return self._pd_of_range(torch.sqrt(dx * dx + dy * dy))

    def pd(self, pose, lm_mean, lm_cov=None):
        dx = lm_mean[..., 0] - pose[..., 0]
        dy = lm_mean[..., 1] - pose[..., 1]
        return self._pd_of_range(torch.sqrt(dx * dx + dy * dy))


@dataclasses.dataclass(frozen=True)
class RangeBearing(_Planar2D):
    """2-D range-bearing model (reference: MeasurementModel_RngBrg.cpp).

    ``R``: [2, 2] measurement noise (already inflated by the app); the
    scalars are the detection probability inside the sensing annulus, the
    uniform clutter intensity, and the annulus with its buffer zone.
    """

    def measure(self, pose, lm_mean, lm_cov=None) -> MeasurePrediction:
        dx = lm_mean[..., 0] - pose[..., 0]
        dy = lm_mean[..., 1] - pose[..., 1]
        r2 = dx * dx + dy * dy
        r = torch.sqrt(r2)
        b = gaussian.wrap_angle(torch.atan2(dy, dx) - pose[..., 2])
        z = torch.stack([r, b], dim=-1)
        # clamped Jacobian denominators keep H finite for a landmark at the
        # sensor (dead slots + a particle at the origin)
        r2s = torch.clamp(r2, min=gaussian.R2_TINY)
        rs = torch.sqrt(r2s)
        H_lmk = gaussian.matrix([[dx / rs, dy / rs],
                                 [-dy / r2s, dx / r2s]])
        zero = torch.zeros_like(r)
        H_pose = gaussian.matrix([[-dx / rs, -dy / rs, zero],
                                  [dy / r2s, -dx / r2s, zero - 1.0]])
        return MeasurePrediction(z, _dense_S(self.R, z, H_lmk, lm_cov),
                                 H_lmk, H_pose, self._in_range(r))

    def measure_p(self, pose, mean, cov=None) -> PlanarPrediction:
        dx = mean[0] - pose[..., 0]
        dy = mean[1] - pose[..., 1]
        r2 = dx * dx + dy * dy
        r = torch.sqrt(r2)
        b = gaussian.wrap_angle(torch.atan2(dy, dx) - pose[..., 2])
        r2s = torch.clamp(r2, min=gaussian.R2_TINY)
        rs = torch.sqrt(r2s)
        H = [[dx / rs, dy / rs], [-dy / r2s, dx / r2s]]
        if cov is not None:
            S = planar.sandwich_sym(H, cov, 2, R=self.R)
        else:
            S = _packed_R(self.R, r.shape)
        return PlanarPrediction((r, b), S, H, self._in_range(r))

    def inverse_p(self, pose, z):
        """``z`` = DZ planes -> (mean[2, ...], cov[3, ...]) via the inverse
        model (MeasurementModel_RngBrg.cpp:117-136)."""
        a = pose[..., 2] + z[1]
        c, s = torch.cos(a), torch.sin(a)
        r = z[0]
        mean = torch.stack([pose[..., 0] + r * c, pose[..., 1] + r * s])
        Hinv = [[c, -r * s], [s, r * c]]
        cov = planar.sandwich_sym(Hinv, planar.pack_sym(self.R), 2)
        return mean, cov

    def inverse(self, pose, z):
        a = pose[..., 2] + z[..., 1]
        c, s = torch.cos(a), torch.sin(a)
        r = z[..., 0]
        mean = torch.stack([pose[..., 0] + r * c, pose[..., 1] + r * s],
                           dim=-1)
        Hinv = gaussian.matrix([[c, -r * s], [s, r * c]])
        return mean, Hinv @ self.R @ Hinv.transpose(-1, -2)

    def clutter_intensity_integral(self, n_z=None) -> float:
        # sensing "area" in measurement space (MeasurementModel_RngBrg.cpp:175-178)
        return self.clutter * 2.0 * math.pi * (self.r_max - self.r_min)

    def sample(self, pose, lm_mean, noise=None, gen=None):
        """A measurement drawn around the prediction, with its validity
        (MeasurementModel.hpp:129-158): the draws ``noise [..., 2]``
        injected, or taken from ``gen``."""
        pred = self.measure(pose, lm_mean)
        z = gaussian.sample(pred.z, self.R.expand(pred.z.shape + (2,)),
                            noise, gen)
        return z, pred.valid


@dataclasses.dataclass(frozen=True)
class XY(_Planar2D):
    """Robot-frame x-y measurement model (reference: MeasurementModel_XY.cpp)."""

    def measure(self, pose, lm_mean, lm_cov=None) -> MeasurePrediction:
        dx = lm_mean[..., 0] - pose[..., 0]
        dy = lm_mean[..., 1] - pose[..., 1]
        c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
        z = torch.stack([c * dx + s * dy, -s * dx + c * dy], dim=-1)
        c, s = c.expand(dx.shape), s.expand(dx.shape)
        H_lmk = gaussian.matrix([[c, s], [-s, c]])
        H_pose = gaussian.matrix([[-c, -s, -dx * s + dy * c],
                                  [s, -c, -dx * c - dy * s]])
        r = torch.sqrt(dx * dx + dy * dy)
        return MeasurePrediction(z, _dense_S(self.R, z, H_lmk, lm_cov),
                                 H_lmk, H_pose, self._in_range(r))

    def measure_p(self, pose, mean, cov=None) -> PlanarPrediction:
        dx = mean[0] - pose[..., 0]
        dy = mean[1] - pose[..., 1]
        c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
        zx = c * dx + s * dy
        zy = -s * dx + c * dy
        cb, sb = c.expand(dx.shape), s.expand(dx.shape)
        H = [[cb, sb], [-sb, cb]]
        if cov is not None:
            S = planar.sandwich_sym(H, cov, 2, R=self.R)
        else:
            S = _packed_R(self.R, dx.shape)
        r = torch.sqrt(dx * dx + dy * dy)
        return PlanarPrediction((zx, zy), S, H, self._in_range(r))

    def inverse_p(self, pose, z):
        c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
        mean = torch.stack([pose[..., 0] + c * z[0] - s * z[1],
                            pose[..., 1] + s * z[0] + c * z[1]])
        cb, sb = c.expand(mean[0].shape), s.expand(mean[0].shape)
        Hinv = [[cb, -sb], [sb, cb]]
        cov = planar.sandwich_sym(Hinv, planar.pack_sym(self.R), 2)
        return mean, cov

    def inverse(self, pose, z):
        c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
        mean = torch.stack([pose[..., 0] + c * z[..., 0] - s * z[..., 1],
                            pose[..., 1] + s * z[..., 0] + c * z[..., 1]],
                           dim=-1)
        Hinv = gaussian.matrix([[c, -s], [s, c]])
        return mean, Hinv @ self.R @ Hinv.transpose(-1, -2)

    def clutter_intensity_integral(self, n_z=None) -> float:
        # area of the sensing annulus (x-y measurement space)
        return self.clutter * math.pi * (self.r_max ** 2 - self.r_min ** 2)


@dataclasses.dataclass(frozen=True)
class Range1D(_Annulus):
    """1-D range model (reference: MeasurementModel_Rng1D.cpp); ``R`` [1, 1],
    poses and landmarks ``(..., 1)``."""

    def measure(self, pose, lm_mean, lm_cov=None) -> MeasurePrediction:
        z = lm_mean - pose
        one = torch.ones(z.shape[:-1] + (1, 1), dtype=z.dtype,
                         device=z.device)
        S = self.R.expand(z.shape + (1,))
        if lm_cov is not None:
            S = S + lm_cov
        return MeasurePrediction(z, S, one, -one,
                                 self._in_range(torch.abs(z[..., 0])))

    def measure_p(self, pose, mean, cov=None) -> PlanarPrediction:
        zz = mean[0] - pose[..., 0]
        S = (cov + self.R[0, 0]) if cov is not None else _packed_R(
            self.R, zz.shape)
        return PlanarPrediction((zz,), S, [[torch.ones_like(zz)]],
                                self._in_range(torch.abs(zz)))

    def inverse_p(self, pose, z):
        mean = torch.stack([pose[..., 0] + z[0]])
        return mean, self.R[0, 0].expand(mean.shape)

    def inverse(self, pose, z):
        mean = pose + z
        return mean, self.R.expand(mean.shape + (1,))

    def pd_p(self, pose, mean, cov=None):
        return self._pd_of_range(torch.abs(mean[0] - pose[..., 0]))

    def pd(self, pose, lm_mean, lm_cov=None):
        return self._pd_of_range(torch.abs(lm_mean[..., 0] - pose[..., 0]))

    def clutter_intensity_integral(self, n_z=None) -> float:
        return self.clutter * 2.0 * (self.r_max - self.r_min)
