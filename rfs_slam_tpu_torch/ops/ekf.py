"""Batched per-landmark EKF correction (port of the JAX package's ``ops/ekf.py``).

The whole ``[P, M]`` landmark batch is corrected against the whole ``[Z]``
measurement batch at once (reference: KalmanFilter.hpp:261-342, called from
RBPHDFilter.hpp:597-641), in the plane-major layout of
:mod:`rfs_slam_tpu_torch.core.planar`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from rfs_slam_tpu_torch.core import gaussian, planar


@dataclasses.dataclass(frozen=True)
class InnovationGates:
    """Innovation gating of the rotation-aware KF subclasses.

    ``wrap_dims`` marks angle components (wrapped before gating);
    thresholds <= 0 disable the gate (KalmanFilter_RngBrg.cpp:40-43).
    """

    thresholds: tuple
    wrap_dims: tuple = ()

    @classmethod
    def range_bearing(cls, range_t: float = -1.0, bearing_t: float = -1.0):
        """KalmanFilter_RngBrg gates (KalmanFilter_RngBrg.cpp:52-65)."""
        return cls(thresholds=(float(range_t), float(bearing_t)),
                   wrap_dims=(1,))

    @classmethod
    def victoria_park(cls, range_t: float = -1.0, bearing_t: float = -1.0,
                      diam_t: float = -1.0):
        """KalmanFilter_VictoriaPark gates (KalmanFilter_VictoriaPark.hpp:56-74)."""
        return cls(thresholds=(float(range_t), float(bearing_t),
                               float(diam_t)), wrap_dims=(1,))

    @classmethod
    def none(cls, dz: int):
        """No gate and no angle on ``dz`` components."""
        return cls(thresholds=(-1.0,) * dz, wrap_dims=())

    def innovation(self, z_exp: torch.Tensor, z_act: torch.Tensor):
        """Stacked-layout innovation ``[..., DZ]``: returns (innovation,
        pass mask ``[...]``)."""
        innov, ok = self.innovation_p([z_exp[..., d] for d in
                                       range(z_exp.shape[-1])],
                                      [z_act[..., d] for d in
                                       range(z_act.shape[-1])])
        return torch.stack(innov, dim=-1), ok

    def innovation_p(self, z_exp, z_act):
        """Plane-layout innovation: returns (list of DZ planes, ok plane)."""
        innov = []
        ok = True
        for d in range(len(z_exp)):
            e = z_act[d] - z_exp[d]
            if d in self.wrap_dims:
                e = gaussian.wrap_angle(e)
            innov.append(e)
            t = self.thresholds[d]
            if t > 0:
                ok = ok & (torch.abs(e) <= t)
        if ok is True:
            ok = torch.ones_like(innov[0], dtype=torch.bool)
        return innov, ok


class PlanarCorrection(NamedTuple):
    """Output of :func:`correct_all` (plane-major).  Per-measurement updated
    means are not materialized: ``mean_upd[d] = m[d] + sum_e K[d*DZ+e] nu[e]``."""

    z_exp: torch.Tensor       # [DZ, P, M]
    S: torch.Tensor           # [TZ, P, M]
    cov_upd: torch.Tensor     # [T, P, M]
    K: torch.Tensor           # [D*DZ, P, M] gain planes (row-major)
    likelihood: torch.Tensor  # [P, Z, M]  N(z; z_exp, S), 0 where invalid
    md2: torch.Tensor         # [P, Z, M]
    valid: torch.Tensor       # [P, Z, M] bool
    measure_valid: torch.Tensor  # [P, M] bool


def _finite_or_zero(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def correct_all(model, gates: InnovationGates, pose: torch.Tensor,
                lm_mean: torch.Tensor, lm_cov: torch.Tensor,
                z: torch.Tensor) -> PlanarCorrection:
    """One-landmark-times-all-measurements EKF correction.

    pose [P, 3]; lm_mean [D, P, M]; lm_cov [T, P, M]; z [Z, DZ].
    """
    D = lm_mean.shape[0]
    pred = model.measure_p(pose[:, None, :], lm_mean, lm_cov)
    DZ = len(pred.z)
    S_inv = planar.inv_sym(pred.S, DZ)
    C_rows = planar.sym_rows(lm_cov, D)
    CHt = planar.matmul(C_rows, planar.transpose_rows(pred.H))
    K = planar.matmul(CHt, planar.sym_rows(S_inv, DZ))
    # NaN scrub of the gain (KalmanFilter.hpp:253-254): every downstream
    # plane is affine in K, and planes must stay finite everywhere
    K = [[_finite_or_zero(k) for k in row] for row in K]
    KH = planar.matmul(K, pred.H)
    A = [[(1.0 if i == j else 0.0) - KH[i][j] for j in range(D)]
         for i in range(D)]
    U = planar.matmul(A, C_rows)
    cov_upd = torch.stack(
        [0.5 * (U[i][j] + U[j][i]) for i in range(D) for j in range(i, D)])

    z_act = [z[:, d][None, :, None] for d in range(DZ)]
    z_exp_b = [pred.z[d][:, None, :] for d in range(DZ)]
    innov, gate_ok = gates.innovation_p(z_exp_b, z_act)

    md2 = planar.quad_sym(S_inv[:, :, None, :], innov, DZ)   # [P, Z, M]
    det_S = planar.det_sym(pred.S, DZ)
    norm = torch.sqrt((2.0 * math.pi) ** DZ * det_S)
    # non-finite likelihood -> 0 (RandomVec.hpp:424-425)
    lik = _finite_or_zero(torch.exp(-0.5 * md2) / norm[:, None, :])

    valid = gate_ok & pred.valid[:, None, :]
    lik = torch.where(valid, lik, torch.zeros_like(lik))
    return PlanarCorrection(
        z_exp=torch.stack(list(pred.z)), S=pred.S, cov_upd=cov_upd,
        K=torch.stack([K[d][e] for d in range(D) for e in range(DZ)]),
        likelihood=lik, md2=md2, valid=valid, measure_valid=pred.valid,
    )


def correct_single(model, gates: InnovationGates, pose: torch.Tensor,
                   lm_mean: torch.Tensor, lm_cov: torch.Tensor, z):
    """Single-measurement EKF correction of each landmark of the batch.

    ``pose`` (..., 3); ``lm_mean`` [D, ...], ``lm_cov`` [T, ...] and ``z``
    [DZ, ...] planes, batch axes aligned.  Returns ``(mean, cov,
    likelihood, md2, valid)``; where the update is invalid, or not finite
    (a degenerate input such as r = 0: the NaN guard of
    KalmanFilter.hpp:253-254), the landmark comes back unchanged (the
    reference skips the update, KalmanFilter.hpp:215-217).
    """
    D = lm_mean.shape[0]
    pred = model.measure_p(pose, lm_mean, lm_cov)
    DZ = len(pred.z)
    S_inv = planar.inv_sym(pred.S, DZ)
    C_rows = planar.sym_rows(lm_cov, D)
    K = planar.matmul(planar.matmul(C_rows, planar.transpose_rows(pred.H)),
                      planar.sym_rows(S_inv, DZ))
    KH = planar.matmul(K, pred.H)
    A = [[(1.0 if i == j else 0.0) - KH[i][j] for j in range(D)]
         for i in range(D)]
    U = planar.matmul(A, C_rows)
    cov_upd = torch.stack(
        [0.5 * (U[i][j] + U[j][i]) for i in range(D) for j in range(i, D)])
    innov, gate_ok = gates.innovation_p(list(pred.z),
                                        [z[d] for d in range(DZ)])
    md2 = planar.quad_sym(S_inv, innov, DZ)
    norm = torch.sqrt((2.0 * math.pi) ** DZ * planar.det_sym(pred.S, DZ))
    lik = _finite_or_zero(torch.exp(-0.5 * md2) / norm)
    mean_upd = torch.stack(
        [lm_mean[d] + sum(K[d][e] * innov[e] for e in range(DZ))
         for d in range(D)])
    finite = (torch.isfinite(mean_upd).all(dim=0)
              & torch.isfinite(cov_upd).all(dim=0))
    valid = gate_ok & pred.valid & finite
    return (torch.where(valid, mean_upd, lm_mean),
            torch.where(valid, cov_upd, lm_cov),
            torch.where(valid, lik, torch.zeros_like(lik)), md2, valid)
