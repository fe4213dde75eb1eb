"""The Victoria Park lidar tree-detection measurement model (port of the JAX
package's ``models/victoria_park.py``): the plane-layout API of the filters
and, for boundary use, the dense API (``measure``, ``inverse``, ``pd``,
``_pd_single``: ``(..., 3)`` means, ``(..., 3, 3)`` covariances), computed
through the plane forms.

Reference: MeasurementModel_VictoriaPark.cpp.  Measurements are
``[range, bearing, diameter]``, landmarks ``[x, y, diameter]``.  The lidar
frame is the pose rotated by -pi/2 (:112-114); the diameter's variance grows
with range^2 * Slb (:131).  Pd counts the 0.5-degree beams that could hit
the tree disc and looks the count up in a table (:202-265), probed at
perpendicular offsets of +-2 diameters up to 3 sigma of the cross-range
uncertainty (:153-199, at most ``N_PROBE_PAIRS`` pairs).  Without a scan
every beam in the window counts as visible; with one (``with_scan``) a beam
counts when its return lies beyond the tree or it has none (0).

The per-scan clutter intensity is a tensor on the model's device, so a
frame loop attaches scans without reading the device.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from rfs_slam_tpu_torch.core import gaussian, planar
from rfs_slam_tpu_torch.models.measurement import (MeasurePrediction,
                                                   PlanarPrediction)

N_PROBE_PAIRS = 3
BEAM_WINDOW = 32  # max beams in a tree's angular window (>= 2*gamma*720/2pi)


@dataclasses.dataclass(frozen=True)
class VictoriaPark:
    """``R`` [3, 3] (inflated), ``slb`` () beam-angle variance, ``pd_table``
    [K] the beam-count -> Pd lookup, ``clutter_value`` () the clutter
    intensity, ``scan720`` [720] the current scan (zeros when absent), and
    the sensing limits (MeasurementModel_VictoriaPark.hpp:136-145)."""

    R: torch.Tensor
    slb: torch.Tensor
    pd_table: torch.Tensor
    clutter_value: torch.Tensor
    scan720: torch.Tensor
    r_max: float = 70.0
    r_min: float = 5.0
    b_max: float = 3.09
    b_min: float = 0.11
    buffer_pd: float = 0.4
    expected_clutter: float = 3.0
    has_scan: bool = False

    def measure_p(self, pose, mean, cov=None) -> PlanarPrediction:
        """``mean[3, ...]`` (x, y, diameter), ``cov[6, ...]`` packed
        (MeasurementModel_VictoriaPark.cpp:96-135)."""
        th = pose[..., 2] - math.pi / 2.0
        dx = mean[0] - pose[..., 0]
        dy = mean[1] - pose[..., 1]
        r2 = dx * dx + dy * dy
        r = torch.sqrt(r2)
        b = gaussian.wrap_angle(torch.atan2(dy, dx) - th)
        # clamped Jacobian denominators keep H finite for a landmark at the
        # sensor (dead slots + a particle at the origin)
        r2s = torch.clamp(r2, min=gaussian.R2_TINY)
        rs = torch.sqrt(r2s)
        zero = torch.zeros_like(r)
        one = torch.ones_like(r)
        H = [[dx / rs, dy / rs, zero], [-dy / r2s, dx / r2s, zero],
             [zero, zero, one]]
        if cov is not None:
            S = planar.sandwich_sym(H, cov, 3, R=self.R)
        else:
            S = torch.stack([self.R[i, j].expand(r.shape)
                             for i in range(3) for j in range(i, 3)])
        k = planar.tri_index(2, 2, 3)
        S = torch.cat([S[:k], (S[k] + r2 * self.slb)[None], S[k + 1:]])
        valid = torch.ones_like(r, dtype=torch.bool)
        return PlanarPrediction((r, b, mean[2] + zero), S, H, valid)

    def inverse_p(self, pose, z):
        """``z`` = (range, bearing, diameter) planes -> (mean[3, ...],
        cov[6, ...])."""
        a = (pose[..., 2] - math.pi / 2.0) + z[1]
        c, s = torch.cos(a), torch.sin(a)
        r = z[0]
        mx = pose[..., 0] + r * c
        my = pose[..., 1] + r * s
        mean = torch.stack([mx, my, z[2].expand(mx.shape)])
        Hinv = [[c, -r * s], [s, r * c]]
        cov2 = planar.sandwich_sym(Hinv, planar.pack_sym(self.R[:2, :2]), 2)
        zero = torch.zeros_like(mx)
        cov = torch.stack([cov2[0] + zero, cov2[1] + zero, zero,
                           cov2[2] + zero, zero,
                           self.R[2, 2].expand(mx.shape)])
        return mean, cov

    def measure(self, pose, lm_mean, lm_cov=None) -> MeasurePrediction:
        """Dense form of :meth:`measure_p`: ``lm_mean [..., 3]``,
        ``lm_cov [..., 3, 3]``; ``H_pose`` is zero (:148)."""
        p = self.measure_p(pose, planar.pack_vec(lm_mean),
                           None if lm_cov is None else planar.pack_sym(lm_cov))
        z = torch.stack(p.z, dim=-1)
        return MeasurePrediction(z, planar.unpack_sym(p.S, 3),
                                 gaussian.matrix(p.H),
                                 torch.zeros(z.shape + (3,), dtype=z.dtype,
                                             device=z.device), p.valid)

    def inverse(self, pose, z):
        """Dense form of :meth:`inverse_p`: ``z [..., 3]`` -> ``(mean [...,
        3], cov [..., 3, 3])``."""
        mean, cov = self.inverse_p(pose, [z[..., d] for d in range(3)])
        return planar.unpack_vec(mean), planar.unpack_sym(cov, 3)

    def _pd_single(self, pose, xy, diameter):
        """Dense form of :meth:`_pd_single_p`: a disc at ``xy [..., 2]``."""
        return self._pd_single_p(pose, xy[..., 0], xy[..., 1], diameter)

    def pd(self, pose, lm_mean, lm_cov=None):
        """Dense form of :meth:`pd_p`: ``lm_mean [..., 3]``, ``lm_cov [...,
        3, 3]`` -> ``(pd, close-to-limit)``."""
        return self.pd_p(pose, planar.pack_vec(lm_mean),
                         None if lm_cov is None else planar.pack_sym(lm_cov))

    def _pd_single_p(self, pose, lx, ly, diameter):
        """probabilityOfDetection2 (:202-265) -> (pd, close-to-limit)."""
        K = self.pd_table.shape[0]
        th = pose[..., 2] - math.pi / 2.0
        dx = lx - pose[..., 0]
        dy = ly - pose[..., 1]
        rng = torch.sqrt(dx * dx + dy * dy)
        ang = gaussian.wrap_angle(torch.atan2(dy, dx) - th)
        in_limits = ((ang <= self.b_max) & (ang >= self.b_min)
                     & (rng >= self.r_min) & (rng <= self.r_max))
        radius = diameter / 2.0
        gamma = torch.atan(radius / rng)
        max_pts = torch.floor(2.0 * gamma * 720.0 / (2.0 * math.pi)).to(
            torch.int32)
        pd_max_pts = self.pd_table[torch.clamp(max_pts, 0, K - 1).long()]
        geo_zero = (max_pts < K) & (pd_max_pts == 0.0)
        close = (max_pts < K) & (pd_max_pts < self.buffer_pd)
        if self.has_scan:
            minb = torch.ceil((ang - gamma) * 720.0 / (2.0 * math.pi)).to(
                torch.int32)
            minb = torch.remainder(minb, 720)
            offs = torch.arange(BEAM_WINDOW, dtype=torch.int32,
                                device=minb.device)
            bins = torch.remainder(minb[..., None] + offs, 720)
            scan_v = self.scan720[bins.long()]
            minrange = rng - radius - 6.0 * 0.03
            visible = (scan_v > minrange[..., None]) | (scan_v == 0.0)
            in_win = offs < torch.clamp(max_pts, max=BEAM_WINDOW)[..., None]
            num_pts = (visible & in_win).sum(dim=-1, dtype=torch.int32)
        else:
            num_pts = max_pts
        pd = self.pd_table[torch.clamp(num_pts, 0, K - 1).long()]
        close = torch.where(pd == 0.0, False, close)
        pd = torch.where(in_limits & ~geo_zero, pd, torch.zeros_like(pd))
        return pd, close & in_limits

    def pd_p(self, pose, mean, cov=None):
        """Multi-probe Pd (probabilityOfDetection, :153-199); the probe
        spread is 3 sigma of ``cov``'s cross-range variance, or 0.2 m
        without ``cov``."""
        lx, ly, diameter = mean[0], mean[1], mean[2]
        bearing = torch.atan2(ly - pose[..., 1], lx - pose[..., 0])
        px, py = -torch.sin(bearing), torch.cos(bearing)
        if cov is not None:
            # cross-range variance of the (x, y) block: packed 0, 1, 3
            var_perp = (px * px * cov[0] + 2.0 * px * py * cov[1]
                        + py * py * cov[3])
            std = torch.clamp(
                3.0 * torch.sqrt(torch.clamp(var_perp, min=0.0)), min=0.2)
        else:
            std = torch.full_like(diameter, 0.2)
        pd_c, close_c = self._pd_single_p(pose, lx, ly, diameter)
        pd_max, pd_min = pd_c, pd_c
        for i in range(1, N_PROBE_PAIRS + 1):
            probe_valid = (i - 1) * 2.0 * diameter < std
            for sgn in (1.0, -1.0):
                off = sgn * i * 2.0 * diameter
                pd_i, _ = self._pd_single_p(pose, lx + off * px,
                                            ly + off * py, diameter)
                pd_i = torch.where(probe_valid, pd_i, pd_c)
                pd_max = torch.maximum(pd_max, pd_i)
                pd_min = torch.minimum(pd_min, pd_i)
        return pd_max, close_c | ((pd_min == 0.0) & (pd_max > 0.0))

    def clutter_intensity(self, z=None, n_z=None) -> torch.Tensor:
        return self.clutter_value

    def clutter_intensity_integral(self, n_z=None) -> float:
        return self.expected_clutter

    def with_scan(self, scan361: torch.Tensor) -> "VictoriaPark":
        """Attach a raw 361-beam scan; the clutter intensity becomes the
        expected clutter count over the scan's FoV polygon area
        (setLaserScan, :267-286), on the device."""
        area = (scan361[1:] * scan361[:-1]).sum() + scan361[0] * scan361[-1]
        area = area * math.sin(math.pi / 360.0) / 2.0
        scan720 = torch.cat([scan361, scan361.new_zeros(720 - 361)])
        return dataclasses.replace(
            self, scan720=scan720,
            clutter_value=self.expected_clutter / torch.clamp(area, min=1e-6),
            has_scan=True)


def fov_area_clutter(expected_clutter, r_min, r_max, b_min, b_max):
    """Constant clutter intensity for the no-scan fallback: the expected
    count over the sensing sector's area."""
    area = 0.5 * (b_max - b_min) * (r_max ** 2 - r_min ** 2)
    return expected_clutter / area
