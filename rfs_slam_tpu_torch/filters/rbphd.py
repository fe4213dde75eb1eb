"""RB-PHD SLAM filter over the whole particle set (port of
the JAX package's ``filters/rbphd.py``).

* ``predict`` = addBirthGaussians + particle propagation + landmark
  covariance growth (RBPHDFilter.hpp:416-442);
* ``update``  = the map update, importance weighting with the exact RFS
  likelihood, GM merge (kernel ``merge2d`` or ``merge3d`` on CUDA, by the
  map's dimension) and prune, and ESS-gated systematic resampling
  (RBPHDFilter.hpp:444-997).

Births with ``birth_count_threshold > 1`` go through the birth-candidate
state machine (RBPHDFilter.hpp:1000-1084).  The map update runs the 2-D
kernel for the 2-D range-bearing model and the general plain-PyTorch
branch for every other model (the Victoria Park model's 3-D maps).

Map state is plane-major: means ``[D, P, M]``, packed covariances
``[T, P, M]``.  Under a particle mesh (``parallel/mesh.py``) the state is
a rank's block of the particles and only resampling communicates; under a
particles x map mesh (``MapMesh``, the 2-D range-bearing filter) it is
also a block of each map's slots, and the steps across slots communicate
over the map group (see ``_map_update``, ``_importance_weights``).
Randomness comes from the caller: ``predict`` takes
standard-normal motion draws ``[P, 3]`` and input draws ``[P, DU]``, and
``update`` the resampling offset ``u0``, or draws them from a
``torch.Generator`` on the state's device.  Nothing in a step waits on the
device except the host-known empty-measurement branch, which the caller can
answer with ``has_z``.  Each phase is a profiler span (``utils/timing.py``:
``rbphd.predict``, ``.births``, ``.update``, ``.map_update``,
``.importance``, ``.merge``, ``.prune``, ``.resample``), and births, merges
and resamplings are tallied, both only while a profiler records.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from rfs_slam_tpu_torch.core import gaussian, planar
from rfs_slam_tpu_torch.core.state import (BirthCandidates, GMState,
                                           ParticleState, rows)
from rfs_slam_tpu_torch.models.measurement import RangeBearing
from rfs_slam_tpu_torch.ops import gm as gm_ops
from rfs_slam_tpu_torch.ops import resample as resample_ops
from rfs_slam_tpu_torch.ops.ekf import (InnovationGates, correct_all,
                                        correct_single)
from rfs_slam_tpu_torch.ops.kernels.map_update2d import (block_sum,
                                                         fused_map_update2d,
                                                         map_update2d_block,
                                                         pack_params)
from rfs_slam_tpu_torch.ops.rfs_likelihood import rfs_log_likelihood
from rfs_slam_tpu_torch.parallel.mesh import MapMesh
from rfs_slam_tpu_torch.utils.timing import span, tally

LOG_TINY = -80.0  # log-domain stand-in for denorm_min (RBPHDFilter.hpp:743)


def _map_mesh(mesh):
    """``mesh`` when it splits the maps (a :class:`MapMesh`), else None."""
    return mesh if isinstance(mesh, MapMesh) else None


@dataclasses.dataclass(frozen=True)
class RBPHDConfig:
    """Static configuration (RBPHDFilter::Config, RBPHDFilter.hpp:90-146,
    plus the capacities that replace dynamic allocation)."""

    n_particles: int = 200
    map_capacity: int = 256
    z_capacity: int = 16
    new_capacity: int = 64
    new_per_z: int = 8
    birth_capacity: int = 16
    eval_capacity: int = 15
    z_dp_max: int = 10

    birth_gaussian_weight: float = 0.25
    birth_count_threshold: int = 1   # 1: every unused measurement is born
    birth_check_threshold: int = 1
    birth_support_dist: float = 1.0
    birth_current_meas_count_threshold: int = 1
    new_gaussian_md_threshold: float = 0.2
    eval_pt_min_weight: float = 0.75
    weighting_md_threshold: float = 3.0
    merge_threshold: float = 0.5
    merge_inflation: float = 1.5
    prune_threshold: float = 0.2
    min_updates_before_resample: int = 1
    min_measurements_before_resample: int = 1
    ess_threshold: float = 200.0
    use_cluster_process: bool = False


@dataclasses.dataclass(frozen=True)
class RBPHDState:
    particles: ParticleState
    gm: GMState
    birth: BirthCandidates
    last_z: torch.Tensor       # [Zc, DZ] measurements of the previous update
    last_unused: torch.Tensor = rows(0)  # [P, Zc] unused-measurement mask
    n_in_fov: torch.Tensor = rows(0)     # [P] landmarks in FOV, last update
    n_updates: torch.Tensor    # () updates since the last resample
    n_meas: torch.Tensor       # () measurements since the last resample


class RBPHDFilter:
    """Wires models and config into the step functions (the reference's
    ``RBPHDFilter<...>``, rbphdslam2dSim.cpp:444-492)."""

    def __init__(self, motion, lmk_model, meas_model,
                 gates: InnovationGates, cfg: RBPHDConfig):
        self.motion = motion
        self.lmk = lmk_model
        self.meas = meas_model
        self.gates = gates
        self.cfg = cfg
        # the map-update kernel's scalars, packed once (reading R back from
        # the device every step would stall the host on the card)
        self._map_params = (
            pack_params(meas_model, gates, cfg.new_gaussian_md_threshold,
                        cfg.birth_gaussian_weight)
            if isinstance(meas_model, RangeBearing) else None)

    # ------------------------------------------------------------------ init
    def init_state(self, pose0: torch.Tensor, dz: int = 2,
                   d: int = 2) -> RBPHDState:
        """Initial state on ``pose0``'s device (pose0: [3]) for ``d``-D
        landmarks and ``dz``-D measurements."""
        c = self.cfg
        dev, dt = pose0.device, pose0.dtype
        zi = torch.zeros((), dtype=torch.int32, device=dev)
        return RBPHDState(
            particles=ParticleState.init(c.n_particles, pose0),
            gm=GMState.empty(c.n_particles, c.map_capacity, d, dev, dt),
            birth=BirthCandidates.empty(c.n_particles, c.birth_capacity, d,
                                        dev, dt),
            last_z=torch.zeros((c.z_capacity, dz), dtype=dt, device=dev),
            last_unused=torch.zeros((c.n_particles, c.z_capacity),
                                    dtype=torch.bool, device=dev),
            n_in_fov=torch.zeros((c.n_particles,), dtype=torch.int32,
                                 device=dev),
            n_updates=zi, n_meas=zi.clone(),
        )

    # --------------------------------------------------------------- predict
    @span("rbphd.predict")
    def predict(self, state: RBPHDState, u: torch.Tensor, dt,
                noise: torch.Tensor | None = None,
                gen: torch.Generator | None = None,
                use_model_noise: bool = True, use_input_noise: bool = False,
                input_cov: torch.Tensor | None = None,
                input_noise: torch.Tensor | None = None,
                birth_check: bool = True, meas=None,
                mesh=None) -> RBPHDState:
        """Reference: RBPHDFilter::predict (RBPHDFilter.hpp:416-442).

        ``noise``: [P, 3] standard-normal motion draws, ``input_noise``:
        [P, DU] input draws; drawn from ``gen`` when None.  ``meas``
        overrides the wired measurement model for the births (the Victoria
        Park frame's model carries its scan).  ``mesh``: the state is this
        rank's block (``parallel/mesh.py``); under a map mesh the births
        run on the map gathered over the map group.
        """
        mm = _map_mesh(mesh)
        gm, birth = state.gm, state.birth
        if birth_check:
            if mm is not None:
                self._check_map_mesh(meas, gm.dim, state.last_z.shape[-1])
                state = dataclasses.replace(state, gm=mm.gather_map(gm))
            gm, birth = self._add_birth_gaussians(state, meas)
            if mm is not None:
                gm = mm.map_block_gm(gm)
        pose = self.motion.sample(
            state.particles.pose, u, dt, noise=noise, gen=gen,
            use_model_noise=use_model_noise, use_input_noise=use_input_noise,
            input_cov=input_cov, input_noise=input_noise)
        # landmark static step: cov += Q_lm (RBPHDFilter.hpp:433-439)
        _, cov = self.lmk.static_step_p(gm.mean, gm.cov, dt)
        gm = dataclasses.replace(gm, cov=torch.where(gm.alive, cov, gm.cov))
        return dataclasses.replace(
            state, gm=gm, birth=birth,
            particles=dataclasses.replace(state.particles, pose=pose))

    @span("rbphd.births")
    def _add_birth_gaussians(self, state: RBPHDState, meas=None):
        """RBPHDFilter::addBirthGaussians (RBPHDFilter.hpp:1000-1084).
        Returns ``(gm, birth)``.

        With ``birth_count_threshold == 1`` every unused measurement of the
        last update becomes a birth Gaussian at once.  Otherwise unused
        measurements support, or become, birth candidates, which are
        promoted once supported often enough (or at once where the map is
        sparse in the field of view) and expire after enough checks.
        """
        cfg = self.cfg
        meas = meas if meas is not None else self.meas
        pose = state.particles.pose                       # [P, 3]
        z = state.last_z                                  # [Zc, DZ]
        dz = z.shape[-1]
        unused = state.last_unused                        # [P, Zc]
        birth = state.birth
        P, Zc = unused.shape
        C = birth.capacity
        w_b = cfg.birth_gaussian_weight
        z_planes = [z[:, d][None, :] for d in range(dz)]
        inv_mean, inv_cov = meas.inverse_p(pose[:, None, :], z_planes)

        def born(mask):
            return torch.where(mask, w_b, 0.0).to(pose.dtype)

        if cfg.birth_count_threshold == 1:
            tally("rbphd.born", unused)
            return gm_ops.replace_weakest(state.gm, inv_mean, inv_cov,
                                          born(unused), unused), birth

        few_in_fov = (state.n_in_fov
                      <= cfg.birth_current_meas_count_threshold)[:, None]
        # ---- candidate matching: each unused measurement supports the
        # lowest-index candidate within the support distance
        pred = meas.measure_p(pose[:, None, :], birth.mean, birth.cov)
        innov, _ = self.gates.innovation_p(
            [pred.z[d][:, :, None] for d in range(dz)],
            [z[:, d][None, None, :] for d in range(dz)])      # [P, C, Zc]
        md2 = planar.quad_sym(planar.inv_sym(pred.S, dz)[:, :, :, None],
                              innov, dz)
        match = (birth.alive[:, :, None] & unused[:, None, :]
                 & (md2 <= cfg.birth_support_dist ** 2))
        c_ids = torch.arange(C, device=pose.device)[None, :, None]
        first_c = torch.where(match, c_ids, C).amin(dim=1)     # [P, Zc]
        z_matched = first_c < C
        claim = match & (c_ids == first_c[:, None, :])

        # each candidate is corrected with its best claimed measurement
        n_match = claim.sum(dim=2, dtype=torch.int32)          # [P, C]
        best_z = torch.where(claim, md2, float("inf")).argmin(dim=2)
        z_best = torch.stack([z[:, d][best_z] for d in range(dz)])
        m_upd, c_upd, _, _, _ = correct_single(
            meas, self.gates, pose[:, None, :], birth.mean, birth.cov,
            z_best)
        has_match = n_match > 0
        birth = dataclasses.replace(
            birth, mean=torch.where(has_match, m_upd, birth.mean),
            cov=torch.where(has_match, c_upd, birth.cov),
            n_support=birth.n_support + n_match)

        # unmatched unused measurements become new candidates, or births at
        # once where the map is sparse in the field of view
        is_new = unused & ~z_matched
        immediate = is_new & few_in_fov
        to_insert = is_new & ~immediate
        tally("rbphd.born", immediate)
        gm = gm_ops.replace_weakest(state.gm, inv_mean, inv_cov,
                                    born(immediate), immediate)

        # new candidates fill the free slots in rank order (stable sorts:
        # free slots and new candidates first, each in index order)
        K = min(C, Zc)
        dest = torch.argsort(birth.alive.int(), dim=1, stable=True)[:, :K]
        src = torch.argsort((~to_insert).int(), dim=1, stable=True)[:, :K]
        n_ok = torch.minimum((~birth.alive).sum(dim=1, keepdim=True),
                             to_insert.sum(dim=1, keepdim=True))
        ok = torch.arange(K, device=pose.device)[None, :] < n_ok

        def put(dst, values):
            """``dst[..., P, C]`` <- ``values[..., P, Zc]`` taken at
            ``src`` and written at ``dest`` where ``ok``."""
            lead = dst.shape[:-2]
            d_i = dest.expand(lead + dest.shape)
            v = torch.gather(values, -1, src.expand(lead + src.shape))
            return dst.scatter(-1, d_i, torch.where(
                ok, v, torch.gather(dst, -1, d_i)))

        birth = BirthCandidates(
            mean=put(birth.mean, inv_mean), cov=put(birth.cov, inv_cov),
            n_support=put(birth.n_support, torch.ones_like(unused,
                                                           dtype=torch.int32)),
            n_checks=put(birth.n_checks, torch.zeros_like(unused,
                                                          dtype=torch.int32)),
            alive=put(birth.alive, torch.ones_like(unused)))

        # ---- promotion and expiry (RBPHDFilter.hpp:1063-1080)
        checks = birth.n_checks + 1
        enough = birth.n_support >= cfg.birth_count_threshold
        trigger = birth.alive & (
            enough | (checks > cfg.birth_check_threshold) | few_in_fov)
        promote = trigger & (enough | few_in_fov)
        tally("rbphd.born", promote)
        gm = gm_ops.replace_weakest(gm, birth.mean, birth.cov, born(promote),
                                    promote)
        return gm, dataclasses.replace(birth, n_checks=checks,
                                       alive=birth.alive & ~trigger)

    # ---------------------------------------------------------------- update
    @span("rbphd.update")
    def update(self, state: RBPHDState, z: torch.Tensor,
               z_mask: torch.Tensor, u0: torch.Tensor | None = None,
               gen: torch.Generator | None = None,
               has_z: bool | None = None, meas=None,
               mesh=None) -> RBPHDState:
        """Reference: RBPHDFilter::update (RBPHDFilter.hpp:444-541).

        ``z`` [Zc, DZ] padded measurements, ``z_mask`` [Zc] validity.
        ``u0``: the resampling offset in [0, 1), drawn from ``gen`` when
        None.  ``has_z``: whether ``z_mask`` has a measurement, when the
        caller knows it on the host (saves a device sync).  ``meas``
        overrides the wired measurement model for this update.  ``mesh``:
        the state is this rank's block of the particle axis
        (``parallel/mesh.py``), where only the resampling phase
        communicates; under a map mesh also a block of the slots.
        """
        if _map_mesh(mesh) is not None:
            self._check_map_mesh(meas, state.gm.dim, z.shape[-1])
        if has_z is None:
            has_z = bool(z_mask.any())
        if not has_z:
            # empty measurement set: only the update counter advances
            # (RBPHDFilter.hpp:448-452)
            return dataclasses.replace(state, n_updates=state.n_updates + 1)
        return self._update_body(state, z, z_mask, u0, gen,
                                 meas if meas is not None else self.meas,
                                 mesh)

    def _check_map_mesh(self, meas, D, dz):
        """A map mesh runs the 2-D range-bearing filter's path only."""
        if not self._fused_2d(meas if meas is not None else self.meas, D,
                              dz):
            raise NotImplementedError(
                "RB-PHD under a map mesh runs the 2-D range-bearing filter "
                "only; the Victoria Park path is not ported yet "
                "(ROADMAP.md, Queue 1: VP RB-PHD and FastSLAM under the map "
                "mesh)")

    def _fused_2d(self, meas, D, dz) -> bool:
        """Whether the map update runs the ``map_update2d`` kernel (at any
        map capacity: its launch plan picks the form from the shape)."""
        return (isinstance(meas, RangeBearing) and D == 2 and dz == 2
                and tuple(self.gates.wrap_dims) == (1,))

    def _update_body(self, state, z, z_mask, u0, gen, meas,
                     mesh=None) -> RBPHDState:
        cfg = self.cfg
        pose = state.particles.pose
        nZ = z_mask.sum(dtype=torch.int32)
        mm = _map_mesh(mesh)

        gm_full, log_w, unused, n_in_fov, clutter_z = self._map_update(
            state, z, z_mask, meas, mm)
        if not cfg.use_cluster_process:
            log_w = self._importance_weights(log_w, pose, gm_full, z, z_mask,
                                             clutter_z, nZ, meas, mm)
        with span("rbphd.merge"):
            # under a map mesh the merge pairs slots over the whole map in
            # weight order
            g = gm_full if mm is None else mm.gather_map(gm_full)
            tally("rbphd.merge_in", g.alive)
            g = gm_ops.merge(g, cfg.merge_threshold, cfg.merge_inflation)
            tally("rbphd.merge_out", g.alive)
            gm_full = g if mm is None else mm.map_block_gm(g)
        with span("rbphd.prune"):
            gm_full = gm_ops.prune(gm_full, cfg.prune_threshold)
        if u0 is None:
            u0 = torch.rand((), generator=gen, dtype=pose.dtype,
                            device=pose.device)
        return self._resample_phase(state, gm_full, log_w, unused, n_in_fov,
                                    z, nZ, u0, mesh)

    @span("rbphd.map_update")
    def _map_update(self, state: RBPHDState, z, z_mask, meas=None,
                    mesh: MapMesh | None = None):
        """Map-update phase (RBPHDFilter.hpp:543-725): the head (the
        ``map_update2d`` kernel for the 2-D range-bearing model, else
        :meth:`_map_update_head`), then the exact top-k over the
        ``Zc * new_per_z`` survivors, ``m + K nu`` at the selected cells only
        (KalmanFilter.hpp:261-342), and ``replace_weakest``.

        Under a map mesh the head is the kernel's block form on this rank's
        slots (``map_update2d_block``: the column sums, picks, unused flags
        and in-view counts global), and the top-k and ``replace_weakest``
        run on the map and the head's planes gathered over the map group;
        the returned map is this rank's block.

        Returns ``(gm_full, log_w, unused, n_in_fov, clutter_z)``.
        """
        cfg = self.cfg
        meas = meas if meas is not None else self.meas
        gm = state.gm
        pose = state.particles.pose
        D = gm.dim
        Zc, dz = z.shape
        T_pz = min(cfg.new_per_z,
                   gm.capacity if mesh is None else mesh.m_global)
        c = meas.clutter_intensity(z, None)
        clutter_z = (c.to(pose.dtype).expand(Zc)
                     if isinstance(c, torch.Tensor) else
                     torch.full((Zc,), c, dtype=pose.dtype,
                                device=pose.device))
        log_w = state.particles.log_w

        if self._fused_2d(meas, D, dz):
            args = (pose, gm.mean[0], gm.mean[1], gm.cov[0], gm.cov[1],
                    gm.cov[2], gm.w, gm.w_prev, gm.alive, z, z_mask,
                    self._map_params)
            if mesh is None:
                fo = fused_map_update2d(*args, new_per_z=T_pz)
                n_in_fov = (fo.pd != 0.0).sum(dim=1, dtype=torch.int32)
            else:
                fo, n_in_fov = map_update2d_block(
                    *args, T_pz, mesh.m_offset, mesh.gather_blocks)
            w_new, w_prev, unused, col_sum = (fo.w, fo.w_prev, fo.unused,
                                              fo.col_sum)
            cand_w, cand_m = fo.cand_w, fo.cand_m
            K_planes, zexp_planes, covupd_planes = fo.K, fo.z_exp, fo.cov_upd
        else:
            (n_in_fov, w_new, w_prev, unused, col_sum, cand_w, cand_m,
             K_planes, zexp_planes, covupd_planes) = self._map_update_head(
                 meas, gm, pose, z, z_mask, clutter_z, T_pz)
        if cfg.use_cluster_process:
            # single-cluster-process weighting (RBPHDFilter.hpp:652-666)
            w_km_sum = torch.where(gm.alive, gm.w, 0.0).sum(dim=1)
            if mesh is not None:
                w_km_sum = block_sum(mesh.gather_blocks({"w": w_km_sum})["w"])
            log_prod = torch.where(z_mask[None, :], torch.log(col_sum),
                                   0.0).sum(dim=1)
            log_w = log_w + w_km_sum + log_prod
        gm_old = dataclasses.replace(gm, w=w_new, w_prev=w_prev)
        if mesh is not None:
            # the picks name any slot: the map and the head's planes whole
            g = mesh.gather_slots({
                **{k: (v, 2) for k, v in (("mean", gm.mean), ("cov", gm.cov),
                                          ("K", K_planes),
                                          ("z_exp", zexp_planes),
                                          ("cov_upd", covupd_planes))},
                **{k: (getattr(gm_old, k), 1)
                   for k in ("w", "w_prev", "alive")}})
            gm = gm_old = GMState(g["mean"], g["cov"], g["w"], g["w_prev"],
                                  g["alive"])
            K_planes, zexp_planes, covupd_planes = (g["K"], g["z_exp"],
                                                    g["cov_upd"])

        # new Gaussians (RBPHDFilter.hpp:675-683): exact top-k of the
        # survivors; cand_w is laid out (t-major, z-minor)
        k = min(cfg.new_capacity, Zc * T_pz)
        top_w, top_c = planar.topk_stable(cand_w, k)
        z_idx = top_c % Zc
        m_idx = torch.gather(cand_m, 1, top_c)
        planes = torch.cat([gm.mean, K_planes, zexp_planes, covupd_planes],
                           dim=0)
        sel = torch.gather(planes, 2,
                           m_idx[None].expand(planes.shape[0], -1, -1))
        mean_sel, K_sel = sel[:D], sel[D:D + D * dz]
        zexp_sel = sel[D + D * dz:D + D * dz + dz]
        new_cov = sel[D + D * dz + dz:]
        z_sel = [z[:, e][z_idx] for e in range(dz)]
        innov_sel, _ = self.gates.innovation_p(
            [zexp_sel[e] for e in range(dz)], z_sel)
        new_mean = torch.stack([
            mean_sel[d] + sum(K_sel[d * dz + e] * innov_sel[e]
                              for e in range(dz))
            for d in range(D)])
        gm_full = gm_ops.replace_weakest(gm_old, new_mean, new_cov, top_w,
                                         top_w > 0.0, sorted_desc=True)
        if mesh is not None:
            gm_full = mesh.map_block_gm(gm_full)
        return gm_full, log_w, unused, n_in_fov, clutter_z

    def _map_update_head(self, meas, gm: GMState, pose, z, z_mask,
                         clutter_z, T_pz):
        """The map update's head for any measurement model, in plain
        PyTorch (the JAX package's non-fused branch): Pd with the
        landmark covariance, :func:`correct_all`, the column-normalised
        ``[P, Zc, M]`` weight table, the missed-detection weights, the
        unused flags, and the top-``T_pz`` landmarks of each column by
        iterated first-index argmax.

        Returns ``(n_in_fov, w, w_prev, unused, col_sum, cand_w, cand_m, K,
        z_exp, cov_upd)`` with ``cand_*`` laid out (t-major, z-minor).
        """
        cfg = self.cfg
        zero = torch.zeros((), dtype=pose.dtype, device=pose.device)
        # probability of detection (RBPHDFilter.hpp:597-609)
        pd_raw, close = meas.pd_p(pose[:, None, :], gm.mean, gm.cov)
        pd_raw = torch.where(gm.alive, pd_raw, zero)
        close = close & gm.alive
        pd = torch.where(close, 1.0, pd_raw).to(pose.dtype)
        n_in_fov = ((pd != 0.0) & gm.alive).sum(dim=1, dtype=torch.int32)

        corr = correct_all(meas, self.gates, pose, gm.mean, gm.cov, z)

        # the nM x nZ weight table [P, Zc, M] (RBPHDFilter.hpp:620-659)
        md_gate = corr.md2 <= cfg.new_gaussian_md_threshold ** 2
        cell = (gm.alive[:, None, :] & (pd[:, None, :] > 0.0)
                & z_mask[None, :, None] & md_gate & (corr.likelihood > 0.0))
        w_tab = torch.where(
            cell, pd[:, None, :] * gm.w[:, None, :] * corr.likelihood, zero)
        col_sum = clutter_z[None, :] + w_tab.sum(dim=2)           # [P, Zc]
        w_tab = torch.where(z_mask[None, :, None],
                            w_tab / col_sum[:, :, None], zero)

        # missed-detection weights (RBPHDFilter.hpp:686-706)
        w_km = gm.w
        w_miss = (1.0 - pd) * w_km
        delta = pd * w_km - w_tab.sum(dim=1)
        comp = close & (w_km > cfg.birth_gaussian_weight) & (delta > 0.0)
        w_miss = torch.where(comp, torch.clamp(w_miss + delta, max=1.0),
                             w_miss)

        # unused measurements (RBPHDFilter.hpp:709-720)
        unused = z_mask[None, :] & ~(w_tab > 0.0).any(dim=2)

        # top-T_pz landmarks per measurement column by iterated argmax
        # (first index on ties, as jnp.argmax)
        m_ids = torch.arange(gm.capacity, device=pose.device)
        v = w_tab
        vals, idxs = [], []
        for _ in range(T_pz):
            am = v.argmax(dim=2)                                  # [P, Zc]
            vals.append(v.amax(dim=2))
            idxs.append(am)
            v = torch.where(m_ids == am[:, :, None], zero, v)
        return (n_in_fov, torch.where(gm.alive, w_miss, gm.w),
                torch.where(gm.alive, w_km, gm.w_prev), unused, col_sum,
                torch.cat(vals, dim=1), torch.cat(idxs, dim=1), corr.K,
                corr.z_exp, corr.cov_upd)

    @span("rbphd.resample")
    def _resample_phase(self, state: RBPHDState, gm_full, log_w, unused,
                        n_in_fov, z, nZ, u0, mesh=None) -> RBPHDState:
        """Resampling phase (RBPHDFilter.hpp:526-539) and state assembly.
        Under ``mesh`` the weights and the ancestor gather are global
        (``ops/resample.py``) and ``parent`` holds global indices."""
        cfg = self.cfg
        allow = ((state.n_updates + 1 >= cfg.min_updates_before_resample)
                 & (state.n_meas + nZ >= cfg.min_measurements_before_resample))
        anc, new_log_w, did = resample_ops.maybe_resample(
            u0, log_w, cfg.ess_threshold, allow, mesh)
        tally("rbphd.resampled", did)
        g = resample_ops.gather_particles(
            {"pose": state.particles.pose, "gm": gm_full,
             "birth": state.birth, "unused": unused, "fov": n_in_fov},
            anc, mesh)
        zero = torch.zeros_like(state.n_updates)
        return RBPHDState(
            particles=ParticleState(
                pose=g["pose"], log_w=new_log_w,
                parent=anc if mesh is None else mesh.block(anc)),
            gm=g["gm"],
            birth=g["birth"],
            last_z=z,
            last_unused=g["unused"],
            n_in_fov=g["fov"],
            n_updates=torch.where(did, zero, state.n_updates + 1),
            n_meas=torch.where(did, zero, state.n_meas + nZ),
        )

    @span("rbphd.importance")
    def _importance_weights(self, log_w, pose, gm: GMState, z, z_mask,
                            clutter_z, nZ, meas=None,
                            mesh: MapMesh | None = None):
        """Reference: RBPHDFilter::importanceWeighting (hpp:728-819).

        Under a map mesh ``gm`` is this rank's slots: the eval points are
        the top of every block's own top-E candidates gathered over the
        map group (stable ties: the lower slot first), and the intensity
        and weight sums are the blocks' partial sums added in block order,
        so every rank of the group computes the same weights."""
        cfg = self.cfg
        meas = meas if meas is not None else self.meas
        D = gm.dim
        E = cfg.eval_capacity
        dz = z.shape[-1]
        if E == 0:
            # no eval points: weight = denorm_min for every particle
            # (hpp:741-744), uniform after normalization
            return torch.full_like(log_w, LOG_TINY)
        zero = torch.zeros((), dtype=log_w.dtype, device=log_w.device)

        # eval points: top-E by weight among w >= minWeight, Pd > 0
        pd_eval, _ = meas.pd_p(pose[:, None, :], gm.mean, gm.cov)
        elig = gm.alive & (gm.w >= cfg.eval_pt_min_weight) & (pd_eval > 0.0)
        score = torch.where(elig, gm.w, torch.full_like(gm.w, float("-inf")))
        _, eval_idx = planar.topk_stable(score, E)               # [P, E]
        eval_valid = torch.gather(elig, 1, eval_idx)
        eval_mean = torch.gather(gm.mean, 2,
                                 eval_idx[None].expand(D, -1, -1))
        eval_pd = torch.gather(pd_eval, 1, eval_idx)
        if mesh is not None:
            # each block's top-E are in (weight desc, slot asc) order and
            # the blocks in slot order: a stable top-E of the blocks'
            # lists in block order is the top-E over the whole map
            got = mesh.gather_blocks({
                "score": torch.gather(score, 1, eval_idx),
                "valid": eval_valid, "mean": eval_mean.movedim(0, -1),
                "pd": eval_pd})

            def by_block(x):             # [P, B * E_b, ...], block-major
                x = x.movedim(0, 1)
                return x.reshape(x.shape[:1] + (-1,) + x.shape[3:])

            _, pick = planar.topk_stable(by_block(got["score"]), E)
            eval_valid = torch.gather(by_block(got["valid"]), 1, pick)
            eval_pd = torch.gather(by_block(got["pd"]), 1, pick)
            eval_mean = torch.gather(
                by_block(got["mean"]), 1,
                pick[:, :, None].expand(-1, -1, D)).movedim(-1, 0)
        n_eval = eval_valid.sum(dim=1)

        # GM intensity at the eval points before/after the update (hpp:765-800)
        diff = [gm.mean[d][:, None, :] - eval_mean[d][:, :, None]
                for d in range(D)]                                # [P, E, M]
        cov_inv = planar.inv_sym(gm.cov, D)
        md2_em = planar.quad_sym(cov_inv[:, :, None, :], diff, D)
        norm_m = torch.sqrt((2.0 * math.pi) ** D * planar.det_sym(gm.cov, D))
        lik_em = torch.exp(-0.5 * md2_em) / norm_m[:, None, :]
        lik_em = torch.where(torch.isfinite(lik_em) & gm.alive[:, None, :],
                             lik_em, zero)
        sums = {
            "int_before": torch.einsum(
                "pem,pm->pe", lik_em, torch.where(gm.alive, gm.w_prev, zero)),
            "int_after": torch.einsum(
                "pem,pm->pe", lik_em, torch.where(gm.alive, gm.w, zero)),
            "sum_before": torch.where(gm.alive, gm.w_prev, zero).sum(dim=1),
            "sum_after": torch.where(gm.alive, gm.w, zero).sum(dim=1)}
        if mesh is not None:
            # the blocks' partial sums, added in block order
            sums = {k: block_sum(v)
                    for k, v in mesh.gather_blocks(sums).items()}
        int_before = gaussian.TINY + sums["int_before"]
        int_after = gaussian.TINY + sums["int_after"]
        log_int_ratio = torch.where(
            eval_valid, torch.log(int_before) - torch.log(int_after),
            zero).sum(dim=1)
        sum_before, sum_after = sums["sum_before"], sums["sum_after"]

        # RFS measurement likelihood at the eval points: S = R (zero
        # landmark covariance), gated (hpp:847-863)
        predE = meas.measure_p(pose[:, None, :], eval_mean)
        innov, _ = self.gates.innovation_p(
            [predE.z[d][:, :, None] for d in range(dz)],
            [z[:, d][None, None, :] for d in range(dz)])          # [P, E, Zc]
        S_inv = planar.inv_sym(predE.S, dz)
        md2 = planar.quad_sym(S_inv[:, :, :, None], innov, dz)
        norm = torch.sqrt((2.0 * math.pi) ** dz * planar.det_sym(predE.S, dz))
        L = torch.exp(-0.5 * md2) / norm[:, :, None]
        L = torch.where(torch.isfinite(L)
                        & (md2 <= cfg.weighting_md_threshold ** 2), L, zero)
        L = L * eval_pd[:, :, None]

        log_ci = math.log(meas.clutter_intensity_integral(nZ))
        log_rfs = rfs_log_likelihood(L, eval_pd, eval_valid,
                                     clutter_z[None, :], z_mask, log_ci,
                                     z_dp_max=cfg.z_dp_max)
        out = log_w + log_rfs + log_int_ratio + (sum_after - sum_before)
        # no eval points: weight <- denorm_min (hpp:741-744)
        return torch.where(n_eval == 0, torch.full_like(out, LOG_TINY), out)
