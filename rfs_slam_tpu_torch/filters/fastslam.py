"""FastSLAM 1.0 and MH-FastSLAM over the whole particle set (port of the
JAX package's ``filters/fastslam.py``; the reference's FastSLAM.hpp:
77-819).

Per-particle EKF landmark maps with log-odds existence weights; the data
association is a batched Hungarian max-sum on a padded ``[NMZ, NMZ]``
log-likelihood table of each particle's in-range landmarks (ranked by
existence weight) against the measurements; MH-FastSLAM takes Murty's
k-best hypotheses instead (``ops/assignment.py::murty_gated``).  In grow
mode (``mh_grow``, the default) the hypotheses become particles on a fixed
``n_particles_max`` axis until the set would overflow it, when it
force-resamples to ``n_particles`` (FastSLAM.hpp:504-563, 728-757): the
selected hypotheses are scored from the table before any map update, and
only they are materialized.  Unused measurements become landmarks (or
landmark candidates, the RB-PHD birth machinery, with a count threshold
above 1).

Map state is plane-major, as in the RB-PHD filter.  Randomness comes from
the caller: ``predict`` takes standard-normal motion draws ``[P, 3]`` and
``update`` the resampling offset ``u0``, or draws them from a
``torch.Generator`` on the state's device.  Nothing in a step reads a
value back from the device; the empty-measurement branch is answered from
the host with ``has_z``.  Each phase is a profiler span while a profiler
records (``utils/timing.py``: ``fastslam.predict``, ``.update``,
``.da_table``, ``.assoc``, ``.map_update``, ``.prune``, ``.births``,
``.resample``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from rfs_slam_tpu_torch.core import gaussian, planar
from rfs_slam_tpu_torch.core.state import (BirthCandidates, GMState,
                                           ParticleState, rows)
from rfs_slam_tpu_torch.ops import gm as gm_ops
from rfs_slam_tpu_torch.ops import resample as resample_ops
from rfs_slam_tpu_torch.ops.assignment import hungarian, murty_gated
from rfs_slam_tpu_torch.ops.ekf import InnovationGates, correct_single
from rfs_slam_tpu_torch.utils.timing import span

_NEG_INF = float("-inf")


def existence_log_odds_delta(pd, p_fa, prior, updated, locked):
    """Log-odds change of a landmark's existence weight after an update
    (FastSLAM.hpp:599-620): ``p_up`` for an associated, updated landmark,
    ``p_down`` for a missed one, 0.5 (no change) for a missed locked one;
    returns ``log(p / (1 - p))``."""
    p_up = ((1.0 - pd) * p_fa * prior + pd * prior) / (
        p_fa + (1.0 - p_fa) * pd * prior)
    p_down = ((1.0 - pd) * prior) / ((1.0 - prior) + (1.0 - pd) * prior)
    p = torch.where(updated, p_up, torch.where(locked, 0.5, p_down))
    return torch.log(p) - torch.log1p(-p)


@dataclasses.dataclass(frozen=True)
class FastSLAMConfig:
    """``FastSLAM::Config`` (FastSLAM.hpp:109-158) plus capacities; the JAX
    package's fields and defaults."""

    n_particles: int = 200
    map_capacity: int = 128
    z_capacity: int = 16
    nmz_capacity: int = 32           # DA table size (>= in-range lmks, Zc)
    candidate_capacity: int = 16

    max_hypotheses: int = 1          # maxNDataAssocHypotheses_
    # particle axis in MH grow mode; None -> 3 * n_particles
    # (FastSLAM.hpp:335)
    n_particles_max: int | None = None
    mh_grow: bool = True
    # Murty children solved per expansion wave (ops/assignment.murty)
    murty_child_cap: int | None = 6
    # particle lanes running the full Murty expansion per update
    # (ops/assignment.murty_gated); None: every lane
    murty_lane_budget: int | None = None
    max_da_loglik_diff: float = 3.0  # maxDataAssocLogLikelihoodDiff_
    min_log_likelihood: float = -10.0  # minLogMeasurementLikelihood_
    existence_prior: float = 0.5     # landmarkExistencePrior_
    lock_weight: float = 10.0        # landmarkLockWeight_
    prune_threshold: float = -5.0    # mapExistencePruneThreshold_ (log odds)
    prune_z_threshold: int = 0       # pruningMeasurementsThreshold_
    cand_support_dist: float = 1.0
    cand_count_threshold: int = 1
    cand_check_threshold: int = 2
    cand_current_meas_count_threshold: int = 1
    min_updates_before_resample: int = 1
    min_measurements_before_resample: int = 1
    ess_threshold: float = 200.0


@dataclasses.dataclass(frozen=True)
class FastSLAMState:
    particles: ParticleState
    gm: GMState                 # w = log-odds existence
    cand: BirthCandidates
    n_in_fov: torch.Tensor = rows(0)  # [P] int32
    n_updates: torch.Tensor     # () updates since the last resample
    n_meas: torch.Tensor        # () measurements since the last resample


def _take(planes, idx):
    """``planes[..., P, M]`` gathered at ``idx [P, K]`` (< M)."""
    return torch.gather(planes, -1, idx.expand(planes.shape[:-2] + idx.shape))


def _put(planes, idx, values, pad: bool):
    """``planes[..., P, M]`` with ``values[..., P, K]`` written at ``idx
    [P, K]`` (distinct per row); with ``pad``, an index ``M`` drops its
    entry."""
    M = planes.shape[-1]
    if pad:
        planes = torch.cat([planes, planes[..., :1]], dim=-1)
    out = planes.scatter(-1, idx.expand(values.shape), values)
    return out[..., :M] if pad else out


def _logit(p: float) -> float:
    """log(p) - log1p(-p) in float32 arithmetic."""
    p32 = np.float32(p)
    return float(np.log(p32) - np.log1p(-p32))


class FastSLAMFilter:
    def __init__(self, motion, lmk_model, meas_model,
                 gates: InnovationGates, cfg: FastSLAMConfig):
        self.motion = motion
        self.lmk = lmk_model
        self.meas = meas_model
        self.gates = gates
        self.cfg = cfg

    @property
    def p_cap(self) -> int:
        """Size of the particle axis: ``n_particles_max`` in MH grow mode
        (the live set grows under it), ``n_particles`` otherwise."""
        c = self.cfg
        if c.max_hypotheses > 1 and c.mh_grow:
            return c.n_particles_max or 3 * c.n_particles
        return c.n_particles

    def init_state(self, pose0: torch.Tensor, d: int = 2) -> FastSLAMState:
        """Initial state on ``pose0``'s device (pose0: [3]); in grow mode
        only the first ``n_particles`` slots start live."""
        c = self.cfg
        P = self.p_cap
        dev, dt = pose0.device, pose0.dtype
        zi = torch.zeros((), dtype=torch.int32, device=dev)
        return FastSLAMState(
            particles=ParticleState.init(P, pose0, n_live=c.n_particles),
            gm=GMState.empty(P, c.map_capacity, d, dev, dt),
            cand=BirthCandidates.empty(P, c.candidate_capacity, d, dev, dt),
            n_in_fov=torch.zeros((P,), dtype=torch.int32, device=dev),
            n_updates=zi, n_meas=zi.clone())

    # --------------------------------------------------------------- predict
    @span("fastslam.predict")
    def predict(self, state: FastSLAMState, u: torch.Tensor, dt,
                noise: torch.Tensor | None = None,
                gen: torch.Generator | None = None,
                use_model_noise: bool = True, use_input_noise: bool = False,
                input_cov: torch.Tensor | None = None,
                input_noise: torch.Tensor | None = None,
                lmk=None, mesh=None) -> FastSLAMState:
        """FastSLAM::predict (FastSLAM.hpp:360-386): propagate the poses
        (``noise`` [P, 3], drawn from ``gen`` when None) and grow the alive
        landmarks' covariances.  Each particle on its own: under ``mesh``
        (the state a rank's block) nothing changes."""
        lmk = self.lmk if lmk is None else lmk
        pose = self.motion.sample(
            state.particles.pose, u, dt, noise=noise, gen=gen,
            use_model_noise=use_model_noise, use_input_noise=use_input_noise,
            input_cov=input_cov, input_noise=input_noise)
        gm = state.gm
        _, cov = lmk.static_step_p(gm.mean, gm.cov, dt)
        gm = dataclasses.replace(gm, cov=torch.where(gm.alive, cov, gm.cov))
        return dataclasses.replace(
            state, gm=gm,
            particles=dataclasses.replace(state.particles, pose=pose))

    # ---------------------------------------------------------------- update
    @span("fastslam.update")
    def update(self, state: FastSLAMState, z: torch.Tensor,
               z_mask: torch.Tensor, u0: torch.Tensor | None = None,
               gen: torch.Generator | None = None,
               has_z: bool | None = None, meas=None,
               mesh=None) -> FastSLAMState:
        """``z`` [Zc, DZ] padded measurements, ``z_mask`` [Zc].  ``u0``:
        the resampling offset in [0, 1), drawn from ``gen`` when None.
        ``has_z``: whether ``z_mask`` has a measurement, when the caller
        knows it on the host.  An empty set only advances the update
        counter.  ``mesh``: the state is this rank's block of the particle
        axis (``parallel/mesh.py``); the steps that cross the blocks (the
        weights, MH's lane budget, child keep and hypothesis-major order)
        take the unsharded decisions on gathered vectors."""
        if getattr(mesh, "map_world", 1) > 1:
            raise NotImplementedError(
                "FastSLAM under a map mesh is not ported yet (ROADMAP.md, "
                "Queue 1: VP RB-PHD and FastSLAM under the map mesh)")
        if has_z is None:
            has_z = bool(z_mask.any())
        if not has_z:
            return dataclasses.replace(state, n_updates=state.n_updates + 1)
        pose = state.particles.pose
        if u0 is None:
            u0 = torch.rand((), generator=gen, dtype=pose.dtype,
                            device=pose.device)
        return self._update_body(state, z, z_mask, u0,
                                 meas if meas is not None else self.meas,
                                 mesh)

    @span("fastslam.da_table")
    def _da_table(self, pose, gm: GMState, z, z_mask, meas):
        """In-range landmarks ranked by descending existence weight into
        the rows of a padded log-likelihood table (FastSLAM.hpp:450-491).

        Returns ``(table [P, NMZ, NMZ], lm_idx [P, NMZ] (M = padding),
        row_valid, pd_rank, gate_tab [P, NMZ, NMZ])``.
        """
        cfg = self.cfg
        P, M = gm.w.shape
        NMZ = cfg.nmz_capacity
        Zc, dz = z.shape
        pd, close = meas.pd_p(pose[:, None, :], gm.mean, gm.cov)
        in_range = gm.alive & ((pd > 0.0) | close)
        # truncation past NMZ drops the weakest (slot order is arbitrary)
        score = torch.where(in_range, gm.w, _NEG_INF)
        order = torch.sort(-score, dim=1, stable=True)[1]
        if M >= NMZ:
            lm_idx = order[:, :NMZ]
            row_valid = torch.gather(in_range, 1, lm_idx)
        else:
            lm_idx = torch.cat([order, torch.full((P, NMZ - M), M,
                                                  dtype=order.dtype,
                                                  device=order.device)], 1)
            row_valid = torch.cat([torch.gather(in_range, 1, order),
                                   torch.zeros((P, NMZ - M), dtype=torch.bool,
                                               device=order.device)], 1)
        lm_safe = torch.clamp(lm_idx, max=M - 1)
        lm_mean, lm_cov = _take(gm.mean, lm_safe), _take(gm.cov, lm_safe)
        pd_rank = torch.gather(pd, 1, lm_safe)

        pred = meas.measure_p(pose[:, None, :], lm_mean, lm_cov)
        innov, gate_ok = self.gates.innovation_p(
            [pred.z[d][:, :, None] for d in range(dz)],
            [z[:, d][None, None, :] for d in range(dz)])    # [P, NMZ, Zc]
        S_inv = planar.inv_sym(pred.S, dz)
        md2 = planar.quad_sym(S_inv[:, :, :, None], innov, dz)
        norm_log = 0.5 * (torch.log(planar.det_sym(pred.S, dz))
                          + dz * gaussian.LOG_2PI)
        logL = -0.5 * md2 - norm_log[:, :, None]
        ok = (row_valid[:, :, None] & pred.valid[:, :, None]
              & z_mask[None, None, :])
        floor = cfg.min_log_likelihood
        logL = torch.where(ok, torch.clamp(logL, min=floor), floor)
        table = torch.full((P, NMZ, NMZ), floor, dtype=logL.dtype,
                           device=logL.device)
        table[:, :, :Zc] = logL
        # the KF innovation gate per (rank, z): the table stays ungated, as
        # the reference's, but grow mode scores hypotheses with it
        gate_tab = torch.zeros((P, NMZ, NMZ), dtype=torch.bool,
                               device=logL.device)
        gate_tab[:, :, :Zc] = gate_ok & ok
        return table, lm_idx, row_valid, pd_rank, gate_tab

    @span("fastslam.map_update")
    def _apply_hypothesis(self, pose, gm: GMState, z, z_mask, da, table,
                          lm_idx, row_valid, pd_rank, log_w, meas):
        """EKF updates, existence log-odds and particle weight for one DA
        hypothesis ``da [P, NMZ]`` (the column of each landmark rank;
        FastSLAM.hpp:569-621, weight :710-717).  Returns ``(gm, z_used
        [P, Zc], log_w, n_in_fov)``."""
        cfg = self.cfg
        P, M = gm.w.shape
        Zc, dz = z.shape
        da_z = torch.clamp(da, max=Zc - 1)
        zsel = torch.stack([z[:, d][da_z] for d in range(dz)])
        L_da = torch.gather(table, 2, da[:, :, None])[:, :, 0]
        assoc_ok = (row_valid & (da < Zc) & z_mask[da_z]
                    & (L_da > cfg.min_log_likelihood))

        lm_safe = torch.clamp(lm_idx, max=M - 1)
        lm_mean, lm_cov = _take(gm.mean, lm_safe), _take(gm.cov, lm_safe)
        m_upd, c_upd, _, _, kf_ok = correct_single(
            meas, self.gates, pose[:, None, :], lm_mean, lm_cov, zsel)
        updated = assoc_ok & kf_ok                  # isUpdatePerformed

        # existence probability (FastSLAM.hpp:599-620)
        nZ = z_mask.sum(dtype=torch.int32)
        n_clutter = meas.clutter_intensity_integral(nZ)
        if not isinstance(n_clutter, torch.Tensor):
            n_clutter = torch.full((), n_clutter, dtype=pose.dtype,
                                   device=pose.device)
        p_fa = n_clutter / torch.clamp(nZ, min=1).to(pose.dtype)
        w_rank = torch.gather(gm.w, 1, lm_safe)
        dw = existence_log_odds_delta(pd_rank, p_fa, cfg.existence_prior,
                                      updated, w_rank > cfg.lock_weight)
        w_new_rank = w_rank + torch.where(row_valid, dw, 0.0)

        # rank space back to the slots (padding rows, lm_idx == M, drop)
        pad = cfg.nmz_capacity > M
        gm = dataclasses.replace(
            gm,
            mean=_put(gm.mean, lm_idx, torch.where(updated, m_upd, lm_mean),
                      pad),
            cov=_put(gm.cov, lm_idx, torch.where(updated, c_upd, lm_cov),
                     pad),
            w=_put(gm.w, lm_idx, torch.where(row_valid, w_new_rank, w_rank),
                   pad))

        # measurement usage and particle weight (FastSLAM.hpp:611, 710-717)
        z_used = ((da_z[:, :, None] == torch.arange(Zc, device=da.device))
                  & updated[:, :, None]).any(dim=1)
        log_w = log_w + torch.where(updated, L_da, 0.0).sum(dim=1)
        return gm, z_used, log_w, updated.sum(dim=1, dtype=torch.int32)

    @span("fastslam.births")
    def _candidates(self, pose, gm: GMState, cand: BirthCandidates, z,
                    z_mask, z_used, n_in_fov, meas):
        """Unused measurements -> the landmark-candidate pipeline
        (FastSLAM.hpp:633-703, the RB-PHD birth machinery).  Returns
        ``(gm, cand)``."""
        cfg = self.cfg
        P, Zc = z_used.shape
        dz = z.shape[-1]
        unused = z_mask[None, :] & ~z_used
        new_lm_w = _logit(cfg.existence_prior)
        inv_mean, inv_cov = meas.inverse_p(
            pose[:, None, :], [z[:, d][None, :] for d in range(dz)])
        few = (n_in_fov <= cfg.cand_current_meas_count_threshold)[:, None]

        if cfg.cand_count_threshold == 1:
            w_new = torch.where(unused, new_lm_w, 0.0).to(pose.dtype)
            return gm_ops.replace_weakest(gm, inv_mean, inv_cov, w_new,
                                          unused), cand

        # each unused measurement supports the lowest-index candidate
        # within the support distance
        C = cand.capacity
        pred = meas.measure_p(pose[:, None, :], cand.mean, cand.cov)
        innov, _ = self.gates.innovation_p(
            [pred.z[d][:, :, None] for d in range(dz)],
            [z[:, d][None, None, :] for d in range(dz)])      # [P, C, Zc]
        md2 = planar.quad_sym(planar.inv_sym(pred.S, dz)[:, :, :, None],
                              innov, dz)
        match = (cand.alive[:, :, None] & unused[:, None, :]
                 & (md2 <= cfg.cand_support_dist ** 2))
        c_ids = torch.arange(C, device=pose.device)[None, :, None]
        first_c = torch.where(match, c_ids, C).amin(dim=1)     # [P, Zc]
        z_matched = first_c < C
        claim = match & (c_ids == first_c[:, None, :])
        n_match = claim.sum(dim=2, dtype=torch.int32)
        best_z = torch.where(claim, md2, float("inf")).argmin(dim=2)
        z_best = torch.stack([z[:, d][best_z] for d in range(dz)])
        m_upd, c_upd, _, _, _ = correct_single(
            meas, self.gates, pose[:, None, :], cand.mean, cand.cov, z_best)
        has_match = n_match > 0
        cand = dataclasses.replace(
            cand, mean=torch.where(has_match, m_upd, cand.mean),
            cov=torch.where(has_match, c_upd, cand.cov),
            n_support=cand.n_support + n_match)

        is_new = unused & ~z_matched
        immediate = is_new & few
        to_insert = is_new & ~immediate
        gm = gm_ops.replace_weakest(
            gm, inv_mean, inv_cov,
            torch.where(immediate, new_lm_w, 0.0).to(pose.dtype), immediate)

        # new candidates fill the free slots in rank order (stable sorts)
        K = min(C, Zc)
        dest = torch.argsort(cand.alive.int(), dim=1, stable=True)[:, :K]
        src = torch.argsort((~to_insert).int(), dim=1, stable=True)[:, :K]
        n_ok = torch.minimum((~cand.alive).sum(dim=1, keepdim=True),
                             to_insert.sum(dim=1, keepdim=True))
        ok = torch.arange(K, device=pose.device)[None, :] < n_ok

        def put(dst, values):
            lead = dst.shape[:-2]
            d_i = dest.expand(lead + dest.shape)
            v = torch.gather(values, -1, src.expand(lead + src.shape))
            return dst.scatter(-1, d_i, torch.where(
                ok, v, torch.gather(dst, -1, d_i)))

        cand = BirthCandidates(
            mean=put(cand.mean, inv_mean), cov=put(cand.cov, inv_cov),
            n_support=put(cand.n_support, torch.ones_like(unused,
                                                          dtype=torch.int32)),
            n_checks=put(cand.n_checks, torch.zeros_like(unused,
                                                         dtype=torch.int32)),
            alive=put(cand.alive, torch.ones_like(unused)))

        # promotion / expiry; a promoted weight is logit(prior) * nChecks
        checks = cand.n_checks + 1
        enough = cand.n_support >= cfg.cand_count_threshold
        trigger = cand.alive & (
            enough | (checks > cfg.cand_check_threshold) | few)
        promote = trigger & (enough | few)
        gm = gm_ops.replace_weakest(
            gm, cand.mean, cand.cov,
            torch.where(promote, new_lm_w * checks, 0.0).to(pose.dtype),
            promote)
        return gm, dataclasses.replace(cand, n_checks=checks,
                                       alive=cand.alive & ~trigger)

    @span("fastslam.prune")
    def _prune(self, gm: GMState, nZ) -> GMState:
        """Existence-log-odds pruning (FastSLAM.hpp:628-631)."""
        cfg = self.cfg
        pruned = gm.alive & (gm.w >= cfg.prune_threshold)
        return dataclasses.replace(gm, alive=torch.where(
            nZ >= cfg.prune_z_threshold, pruned, gm.alive))

    def _update_body_mh_grow(self, state: FastSLAMState, z, z_mask, u0,
                             table, lm_idx, row_valid, pd_rank, gate_tab,
                             meas, mesh=None) -> FastSLAMState:
        """MH-FastSLAM with the reference's particle-set growth
        (FastSLAM.hpp:504-563, resampleWithMapCopy :728-757), selection
        before materialization: every ``P_cap x H`` hypothesis is scored
        from the table (its post-update weight is ``w_p / n_h * exp(sum of
        its gated associations' likelihoods)``), the resample-or-keep rule
        runs on that flat distribution, and only the selected hypothesis of
        each surviving slot is applied.

        Under ``mesh`` the rows are the rank's block: the ``[P, H]``
        hypothesis weights and the live counts are all-gathered, so the
        keep, force and resample decisions and the flat order ``h * P_cap +
        p`` run over the global ``P_cap`` as unsharded; the selected
        parents' rows, with their DA rows, come through the packed
        ancestor gather."""
        cfg = self.cfg
        pose, gm = state.particles.pose, state.gm
        P_loc = pose.shape[0]
        P_cap = P_loc if mesh is None else mesh.p_global
        P_init = cfg.n_particles
        H = cfg.max_hypotheses
        NMZ = cfg.nmz_capacity
        Zc = z.shape[0]
        dev = pose.device
        nZ = z_mask.sum(dtype=torch.int32)
        log_w = state.particles.log_w
        alive_p = torch.isfinite(log_w)

        # k-best hypotheses per live slot (the real-assignment block)
        n_m = row_valid.sum(dim=1)
        with span("fastslam.assoc"):
            das, scores, valid = murty_gated(
                table, H, n_m, real_cols=nZ, child_cap=cfg.murty_child_cap,
                prune_window=cfg.max_da_loglik_diff,
                budget=cfg.murty_lane_budget, mesh=mesh)  # [Pc,H,NMZ], [Pc,H]
        keep = (valid & (scores[:, :1] - scores <= cfg.max_da_loglik_diff)
                & alive_p[:, None])
        keep[:, 0] = alive_p                            # best always kept
        n_h = torch.clamp(keep.sum(dim=1, dtype=torch.int32), min=1)

        # the exact post-update weight of each hypothesis
        zmask_pad = torch.zeros(NMZ, dtype=torch.bool, device=dev)
        zmask_pad[:Zc] = z_mask
        L_sums = []
        for h in range(H):
            da_h = das[:, h, :]
            L_da = torch.gather(table, 2, da_h[:, :, None])[:, :, 0]
            ok = (row_valid & (da_h < Zc) & zmask_pad[da_h]
                  & (L_da > cfg.min_log_likelihood)
                  & torch.gather(gate_tab, 2, da_h[:, :, None])[:, :, 0])
            L_sums.append(torch.where(ok, L_da, 0.0).sum(dim=1))
        L_sum = torch.stack(L_sums, dim=1)              # [Pc, H]
        hyp_lw = torch.where(
            keep, log_w[:, None] - torch.log(n_h.to(log_w.dtype))[:, None]
            + L_sum, _NEG_INF)
        count = torch.where(alive_p, n_h, 0)
        if mesh is not None:
            both = mesh.all_gather(torch.cat(
                [hyp_lw, count[:, None].to(hyp_lw.dtype)], dim=1))
            hyp_lw, count = both[:, :H], both[:, H]
        flat_lw = hyp_lw.T.reshape(-1)                  # h * P_cap + p

        # resampleWithMapCopy (FastSLAM.hpp:728-757)
        count = count.sum()
        force = count > P_cap
        gates_met = (
            (state.n_updates + 1 >= cfg.min_updates_before_resample)
            & (state.n_meas + nZ >= cfg.min_measurements_before_resample))
        do_rs = force | (gates_met & (resample_ops.effective_count(flat_lw)
                                      <= cfg.ess_threshold))
        # resample: P_init ancestors over the whole hypothesis CDF
        with span("fastslam.resample"):
            anc_rs = torch.cat([
                resample_ops.systematic_ancestors(u0, flat_lw, P_init),
                torch.zeros(P_cap - P_init, dtype=torch.long, device=dev)])
        slot = torch.arange(P_cap, device=dev)
        alive_rs = slot < P_init
        lw_rs = torch.where(alive_rs, -math.log(float(P_init)), _NEG_INF)
        # keep: every kept hypothesis becomes a particle (it fits)
        keep_flat = torch.isfinite(flat_lw)
        anc_keep = torch.sort((~keep_flat).int(), stable=True)[1][:P_cap]
        alive_keep = slot < keep_flat.sum()
        lw_keep = resample_ops.normalize_log_weights(
            torch.where(alive_keep, flat_lw[anc_keep], _NEG_INF))

        anc_flat = torch.where(do_rs, anc_rs, anc_keep)
        out_alive = torch.where(do_rs, alive_rs, alive_keep)
        new_log_w = torch.where(out_alive,
                                torch.where(do_rs, lw_rs, lw_keep), _NEG_INF)
        parent = anc_flat % P_cap
        hyp = anc_flat // P_cap

        # materialize only the selected hypotheses
        with span("fastslam.resample"):
            g = resample_ops.gather_particles(
                {"pose": pose, "gm": gm, "cand": state.cand, "das": das,
                 "table": table, "lm_idx": lm_idx, "row_valid": row_valid,
                 "pd_rank": pd_rank}, parent, mesh)
        if mesh is not None:
            parent, hyp, out_alive, new_log_w = (
                mesh.block(x) for x in (parent, hyp, out_alive, new_log_w))
        da = torch.gather(g["das"], 1, hyp[:, None, None].expand(
            -1, 1, NMZ))[:, 0]
        gm2, z_used, _, n_in_fov = self._apply_hypothesis(
            g["pose"], g["gm"], z, z_mask, da, g["table"], g["lm_idx"],
            g["row_valid"], g["pd_rank"],
            torch.zeros(P_loc, dtype=pose.dtype, device=dev), meas)
        gm2 = self._prune(gm2, nZ)
        gm2, cand = self._candidates(g["pose"], gm2, g["cand"], z, z_mask,
                                     z_used, n_in_fov, meas)
        # dead slots keep no map
        gm2 = dataclasses.replace(gm2, alive=gm2.alive & out_alive[:, None])
        zero = torch.zeros_like(state.n_updates)
        return FastSLAMState(
            particles=ParticleState(pose=g["pose"], log_w=new_log_w,
                                    parent=parent),
            gm=gm2, cand=cand, n_in_fov=n_in_fov,
            n_updates=torch.where(do_rs, zero, state.n_updates + 1),
            n_meas=torch.where(do_rs, zero, state.n_meas + nZ))

    def _update_body(self, state: FastSLAMState, z, z_mask, u0,
                     meas, mesh=None) -> FastSLAMState:
        cfg = self.cfg
        pose, gm = state.particles.pose, state.gm
        P = pose.shape[0]
        nZ = z_mask.sum(dtype=torch.int32)
        table, lm_idx, row_valid, pd_rank, gate_tab = self._da_table(
            pose, gm, z, z_mask, meas)

        H = cfg.max_hypotheses
        if H > 1 and cfg.mh_grow:
            return self._update_body_mh_grow(
                state, z, z_mask, u0, table, lm_idx, row_valid, pd_rank,
                gate_tab, meas, mesh)
        if H == 1:
            with span("fastslam.assoc"):
                da, _ = hungarian(table)
            gm, z_used, log_w, n_in_fov = self._apply_hypothesis(
                pose, gm, z, z_mask, da, table, lm_idx, row_valid, pd_rank,
                state.particles.log_w, meas)
            cand = state.cand
        else:
            # k-best hypotheses, weight split (FastSLAM.hpp:547-563); a
            # hypothesis outside the window collapses to the best and
            # carries -inf (the fixed-shape deviation of mh_grow=False)
            with span("fastslam.assoc"):
                das, scores, valid = murty_gated(
                    table, H, row_valid.sum(dim=1), real_cols=nZ,
                    child_cap=cfg.murty_child_cap,
                    prune_window=cfg.max_da_loglik_diff,
                    budget=cfg.murty_lane_budget, mesh=mesh)
            keep = valid & (scores[:, :1] - scores <= cfg.max_da_loglik_diff)
            das = torch.where(keep[:, :, None], das, das[:, :1, :])
            split_log_w = state.particles.log_w - torch.log(
                keep.sum(dim=1).to(pose.dtype))
            outs = [self._apply_hypothesis(
                pose, gm, z, z_mask, das[:, h, :], table, lm_idx, row_valid,
                pd_rank, split_log_w, meas) for h in range(H)]
            gms = [o[0] for o in outs]
            gm = GMState(*(torch.cat([getattr(g, f.name) for g in gms],
                                     dim=-2)
                           for f in dataclasses.fields(GMState)))
            z_used = torch.cat([o[1] for o in outs])
            log_w = torch.cat([o[2] for o in outs])
            n_in_fov = torch.cat([o[3] for o in outs])
            pose = pose.repeat(H, 1)
            c = state.cand
            cand = BirthCandidates(*(getattr(c, f.name).repeat(
                (1,) * (getattr(c, f.name).dim() - 2) + (H, 1))
                for f in dataclasses.fields(BirthCandidates)))
            # duplicated hypotheses carry -inf
            log_w = torch.where(keep.T.reshape(-1), log_w, _NEG_INF)

        gm = self._prune(gm, nZ)
        gm, cand = self._candidates(pose, gm, cand, z, z_mask, z_used,
                                    n_in_fov, meas)

        # resampling back to n_particles (FastSLAM.hpp:728-757)
        allow = ((state.n_updates + 1 >= cfg.min_updates_before_resample)
                 & (state.n_meas + nZ >= cfg.min_measurements_before_resample))
        with span("fastslam.resample"):
            P_all = P if mesh is None else mesh.p_global
            rows = None
            if H == 1:
                anc, new_log_w, did = resample_ops.maybe_resample(
                    u0, log_w, cfg.ess_threshold, allow, mesh)
            else:
                if mesh is not None:
                    # the copies in the unsharded order h * P_all + p
                    log_w = mesh.all_gather(log_w.view(H, P).T).T.reshape(-1)
                anc = resample_ops.systematic_ancestors(u0, log_w, P_all)
                new_log_w = torch.full((P,), -math.log(P_all),
                                       dtype=log_w.dtype, device=log_w.device)
                did = torch.ones((), dtype=torch.bool, device=log_w.device)
                if mesh is not None:
                    # copy h * P_all + p sits in row h * P + p % P of rank
                    # p // P's block of the gathered rows
                    h, p = anc // P_all, anc % P_all
                    rows = (p // P) * (H * P) + h * P + p % P
            g = resample_ops.gather_particles(
                {"pose": pose, "gm": gm, "cand": cand, "fov": n_in_fov},
                anc if rows is None else rows, mesh)
        zero = torch.zeros_like(state.n_updates)
        # the recorded ancestry indexes the previous step's P particles
        # (copy h * P + p descends from particle p); under a mesh, the
        # global ones
        parent = anc % P_all
        return FastSLAMState(
            particles=ParticleState(
                pose=g["pose"], log_w=new_log_w,
                parent=parent if mesh is None else mesh.block(parent)),
            gm=g["gm"], cand=g["cand"], n_in_fov=g["fov"],
            n_updates=torch.where(did, zero, state.n_updates + 1),
            n_meas=torch.where(did, zero, state.n_meas + nZ))
