"""The 2-D range-bearing measurement model (port of
the JAX package's ``RangeBearing`` (``models/measurement.py``), plane-layout API).

Poses ``(..., 3)`` broadcast against landmark planes ``mean[2, ...]``;
callers align axes (pose ``[P, 1, 3]`` against ``[P, M]`` planes).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from rfs_slam_tpu_torch.core import gaussian, planar


class PlanarPrediction(NamedTuple):
    z: tuple              # DZ planes
    S: torch.Tensor       # [TZ, ...] packed innovation covariance planes
    H: list               # DZ x D nested list of H_lmk planes
    valid: torch.Tensor   # bool plane


@dataclasses.dataclass(frozen=True)
class RangeBearing:
    """2-D range-bearing model (reference: MeasurementModel_RngBrg.cpp).

    ``R``: [2, 2] measurement noise (already inflated by the app); the
    scalars are the detection probability inside the sensing annulus, the
    uniform clutter intensity, and the annulus with its buffer zone.
    """

    R: torch.Tensor
    pd_const: float = 0.95
    clutter: float = 0.1
    r_max: float = 5.0
    r_min: float = 0.3
    r_buf: float = 0.25

    def measure_p(self, pose, mean, cov=None) -> PlanarPrediction:
        dx = mean[0] - pose[..., 0]
        dy = mean[1] - pose[..., 1]
        r2 = dx * dx + dy * dy
        r = torch.sqrt(r2)
        b = gaussian.wrap_angle(torch.atan2(dy, dx) - pose[..., 2])
        # clamped Jacobian denominators keep H finite for a landmark at the
        # sensor (dead slots + a particle at the origin)
        r2s = torch.clamp(r2, min=gaussian.R2_TINY)
        rs = torch.sqrt(r2s)
        H = [[dx / rs, dy / rs], [-dy / r2s, dx / r2s]]
        if cov is not None:
            S = planar.sandwich_sym(H, cov, 2, R=self.R)
        else:
            S = torch.stack([self.R[0, 0].expand(r.shape),
                             self.R[0, 1].expand(r.shape),
                             self.R[1, 1].expand(r.shape)])
        valid = (r <= self.r_max) & (r >= self.r_min)
        return PlanarPrediction((r, b), S, H, valid)

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

    def pd_p(self, pose, mean, cov=None):
        """Returns (pd plane, close-to-limit plane)
        (MeasurementModel_RngBrg.cpp:138-167)."""
        dx = mean[0] - pose[..., 0]
        dy = mean[1] - pose[..., 1]
        r = torch.sqrt(dx * dx + dy * dy)
        inside = (r <= self.r_max) & (r >= self.r_min)
        pd = torch.where(inside, self.pd_const, 0.0).to(r.dtype)
        near_inner = inside & ((r >= self.r_max - self.r_buf)
                               | (r <= self.r_min + self.r_buf))
        near_outer = (~inside) & ((r <= self.r_max + self.r_buf)
                                  & (r >= self.r_min - self.r_buf))
        return pd, near_inner | near_outer

    def clutter_intensity(self, z=None, n_z=None) -> float:
        return self.clutter

    def clutter_intensity_integral(self, n_z=None) -> float:
        # sensing "area" in measurement space (MeasurementModel_RngBrg.cpp:175-178)
        return self.clutter * 2.0 * math.pi * (self.r_max - self.r_min)
