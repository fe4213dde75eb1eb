"""The reference's own wiring of each configuration and its own step: the
models and filter built from the configuration file's numbers, the step of
the 2-D simulation (predict, the ground-truth lock, update) and the frame
of the Victoria Park path (births with the frame's model, the predict
substeps, update), and the Victoria Park frame inputs read from the
stream's files.  Nothing here comes from the program under test."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import vp_loader
from .ekf import InnovationGates
from .measurement import RangeBearing
from .motion import Ackerman2D, Odometry2D, StaticLandmark
from .rbphd import RBPHDConfig, RBPHDFilter, RBPHDState
from .state import BirthCandidates, GMState, ParticleState
from .vp_model import VictoriaPark, fov_area_clutter


def _ten(a, device):
    # formed in float64, rounded once
    return torch.tensor(np.asarray(a, dtype=np.float64), dtype=torch.float32,
                        device=device)


# ------------------------------------------------------------------- 2-D sim
def filter2d(cfg: dict, device) -> RBPHDFilter:
    """The 2-D simulation's filter from the configuration's ``sim``,
    ``models`` and ``filter`` sections (rbphdslam2dSim.cpp:444-492)."""
    sim, mod = cfg["sim"], cfg["models"]
    dt = sim["dt"]
    motion = Odometry2D(Q=_ten(np.diag([sim["vardx"], sim["vardy"],
                                        sim["vardz"]])
                               * (mod["process_noise_inflation"] * dt * dt),
                               device))
    lmk = StaticLandmark(Q=_ten(np.diag([sim["varlmx"], sim["varlmy"]])
                                * (dt * dt), device))
    meas = RangeBearing(
        R=_ten(np.diag([sim["varzr"], sim["varzb"]])
               * mod["measurement_noise_inflation"], device),
        pd_const=sim["pd"], clutter=sim["clutter"], r_max=sim["range_max"],
        r_min=sim["range_min"], r_buf=sim["range_buffer"])
    gates = InnovationGates.range_bearing(range_t=mod["gate_range"],
                                          bearing_t=mod["gate_bearing"])
    return RBPHDFilter(motion, lmk, meas, gates, RBPHDConfig(**cfg["filter"]))


def init2d(filt: RBPHDFilter, device):
    return filt.init_state(torch.zeros(3, device=device))


def step2d(filt: RBPHDFilter, state, odo, z, z_mask, gt, lock: bool,
           has_z: bool, gen: torch.Generator, dt: float):
    """One timestep: predict with draws from ``gen``, the pose set to the
    ground truth where ``lock``, then the update."""
    state = filt.predict(state, odo, dt, gen=gen)
    if lock:
        pose = gt.expand_as(state.particles.pose).contiguous()
        state = dataclasses.replace(state, particles=dataclasses.replace(
            state.particles, pose=pose))
    return filt.update(state, z, z_mask, gen=gen, has_z=has_z)


# ------------------------------------------------------------ Victoria Park
def vp_models(x: dict, device):
    """``(filter, input_cov)`` of the Victoria Park configuration's ``xml``
    settings (rbphdslam_VictoriaPark.cpp:360-400), ``x`` the settings by
    their XML keys."""
    motion = Ackerman2D(Q=_ten(np.zeros((3, 3)), device),
                        h=x["process.AckermanModel.rearWheelOffset"],
                        l=x["process.AckermanModel.frontToRearDist"],
                        dx=x["process.AckermanModel.sensorOffset_x"],
                        dy=x["process.AckermanModel.sensorOffset_y"])
    input_cov = _ten(np.diag([x["process.varuv"], x["process.varur"]]),
                     device)
    lmk = StaticLandmark(Q=_ten(np.diag([x["landmarks.varlmx"],
                                         x["landmarks.varlmy"],
                                         x["landmarks.varlmd"]]), device),
                         per_dt2=True)
    R = (np.diag([x["measurements.varzr"], x["measurements.varzb"],
                  x["measurements.varzd"]])
         * x["filter.update.measurementNoiseInflationFactor"])
    b_min = x["measurements.bearingLimitMin"] * np.pi / 180
    b_max = x["measurements.bearingLimitMax"] * np.pi / 180
    r_min = x["measurements.rangeLimitMin"]
    r_max = x["measurements.rangeLimitMax"]
    n_clutter = x["measurements.expectedNClutter"]
    meas = VictoriaPark(
        R=_ten(R, device), slb=_ten(x["measurements.varza"], device),
        pd_table=_ten(x["measurements.Pd"], device),
        clutter_value=_ten(fov_area_clutter(n_clutter, r_min, r_max, b_min,
                                            b_max), device),
        scan720=torch.zeros(720, device=device), r_max=r_max, r_min=r_min,
        b_max=b_max, b_min=b_min, buffer_pd=x["measurements.bufferZonePd"],
        expected_clutter=n_clutter)
    t = "filter.update.KalmanFilter.innovationThreshold."
    gates = InnovationGates.victoria_park(x[t + "range"], x[t + "bearing"])
    b = "filter.predict.birthGaussian."
    P = x["filter.nParticles"]
    fcfg = RBPHDConfig(
        n_particles=P, map_capacity=x["app.map_capacity"],
        z_capacity=x["app.z_capacity"], new_capacity=x["app.new_capacity"],
        birth_capacity=x["app.birth_capacity"],
        eval_capacity=x["filter.weighting.nEvalPt"],
        z_dp_max=x["app.z_dp_max"],
        birth_gaussian_weight=x[b + "Weight"],
        birth_count_threshold=x[b + "SupportMeasurementThreshold"],
        birth_check_threshold=x[b + "CheckCountThreshold"],
        birth_support_dist=x[b + "SupportMeasurementDist"],
        birth_current_meas_count_threshold=x[
            b + "CurrentMeasurementCountThreshold"],
        new_gaussian_md_threshold=x[
            "filter.update.GaussianCreateInnovMDThreshold"],
        eval_pt_min_weight=x["filter.weighting.minWeight"],
        weighting_md_threshold=x["filter.weighting.threshold"],
        merge_threshold=x["filter.merge.threshold"],
        merge_inflation=x["filter.merge.covInflationFactor"],
        prune_threshold=x["filter.prune.threshold"],
        min_updates_before_resample=x["filter.resampling.minTimesteps"],
        min_measurements_before_resample=x[
            "filter.resampling.minMeasurements"],
        ess_threshold=float(x["filter.resampling.effNParticle"]),
        use_cluster_process=bool(x["filter.weighting.useClusterProcess"]))
    return RBPHDFilter(motion, lmk, meas, gates, fcfg), input_cov


def add_clutter(meas, z, z_mask, rate: float, seed: int):
    """Poisson(``rate``) artificial clutter in each frame's free slots,
    uniform in the sensing sector (rbphdslam_VictoriaPark.cpp:555-580)."""
    z, z_mask = z.copy(), z_mask.copy()
    if rate > 0:
        rng = np.random.default_rng(seed)
        for j in range(len(z)):
            n_c = rng.poisson(rate)
            free = np.nonzero(~z_mask[j])[0]
            for i in range(min(n_c, len(free))):
                r = rng.uniform(float(meas.r_min), float(meas.r_max))
                b = rng.uniform(float(meas.b_min), float(meas.b_max))
                z[j, free[i]] = [r, b, 1.0]
                z_mask[j, free[i]] = True
    return z, z_mask


@dataclasses.dataclass
class VPInputs:
    """A stream's frame inputs as the filter takes them: host ``dts`` [F,
    K] float32 (0 on padding), ``noise`` [F, K] flags, ``has_z`` [F], and
    device ``u`` [F, K, 2], ``z`` [F, Zc, 3], ``z_mask`` [F, Zc]."""

    dts: np.ndarray
    noise: np.ndarray
    has_z: np.ndarray
    u: torch.Tensor
    z: torch.Tensor
    z_mask: torch.Tensor


def vp_inputs(filt: RBPHDFilter, data_dir: str, x: dict, clutter_seed: int,
              device) -> VPInputs:
    """The frame inputs of the stream in ``data_dir``, read from its files
    (:mod:`vp_loader`) with the configuration's artificial clutter."""
    ack = tuple(x["process.AckermanModel." + k] for k in (
        "rearWheelOffset", "frontToRearDist", "sensorOffset_x",
        "sensorOffset_y"))
    fr = vp_loader.load(data_dir, scale_ur=x["process.ur_scale"],
                        z_capacity=x["app.z_capacity"], ackerman=ack)
    z, z_mask = add_clutter(filt.meas, fr.z, fr.z_mask,
                            x["measurements.addedClutter"], clutter_seed)
    return VPInputs(
        dts=np.where(fr.pred_valid, fr.pred_dt, 0).astype(np.float32),
        noise=np.asarray(fr.pred_noise), has_z=z_mask.any(axis=1),
        u=torch.as_tensor(fr.pred_u, dtype=torch.float32, device=device),
        z=torch.as_tensor(z, dtype=torch.float32, device=device),
        z_mask=torch.as_tensor(z_mask, dtype=torch.bool, device=device))


def init_vp(filt: RBPHDFilter, device):
    return filt.init_state(torch.zeros(3, device=device), dz=3, d=3)


def frame_vp(filt: RBPHDFilter, state, inp: VPInputs, j: int,
             input_cov: torch.Tensor, gen: torch.Generator):
    """Frame ``j``: births with the frame's model, the frame's predict
    substeps with dt > 0, then the update, the draws from ``gen``."""
    gm, birth = filt._add_birth_gaussians(state, filt.meas)
    state = dataclasses.replace(state, gm=gm, birth=birth)
    for i in np.nonzero(inp.dts[j])[0]:
        state = filt.predict(
            state, inp.u[j, i], float(inp.dts[j, i]), gen=gen,
            use_model_noise=False, use_input_noise=bool(inp.noise[j, i]),
            input_cov=input_cov, birth_check=False)
    return filt.update(state, inp.z[j], inp.z_mask[j], gen=gen,
                       has_z=bool(inp.has_z[j]), meas=filt.meas)



def state_from(fields: dict) -> RBPHDState:
    """A reference state from a state's tensors by dotted field name (as
    ``check.flatten`` gives them)."""
    def part(cls, prefix):
        return cls(**{f.name: fields[prefix + f.name]
                      for f in dataclasses.fields(cls)})

    return RBPHDState(
        particles=part(ParticleState, "particles."), gm=part(GMState, "gm."),
        birth=part(BirthCandidates, "birth."), last_z=fields["last_z"],
        last_unused=fields["last_unused"], n_in_fov=fields["n_in_fov"],
        n_updates=fields["n_updates"], n_meas=fields["n_meas"])
