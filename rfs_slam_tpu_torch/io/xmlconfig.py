"""Reference-compatible XML configuration parsing (a copy of the JAX
package's ``io/xmlconfig.py``).

Parses the reference's Boost property-tree XML configs UNCHANGED
(cfg/rbphdslam2dSim.xml, cfg/fastslam2dSim.xml, cfg/*VictoriaPark*.xml —
key paths per the readConfigFile functions: rbphdslam2dSim.cpp:77-145,
fastslam2dSim.cpp, rbphdslam_VictoriaPark.cpp:85-184), so the same experiment
definitions drive both implementations.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Any


class XmlConfig:
    """Property-tree-style access: get('filter.nParticles', default)."""

    def __init__(self, path: str):
        self.root = ET.parse(path).getroot()  # <config>
        self.path = path

    def get(self, dotted: str, default: Any = None, type_=None):
        node = self.root
        for part in dotted.split("."):
            node = node.find(part)
            if node is None:
                if default is None and type_ is None:
                    raise KeyError(f"{dotted} missing in {self.path}")
                return default
        text = (node.text or "").strip()
        if type_ is None:
            type_ = type(default) if default is not None else float
        if type_ is bool:
            return text in ("1", "true", "True")
        return type_(text)

    def get_list(self, dotted: str, tag: str, type_=float):
        node = self.root
        for part in dotted.split("."):
            node = node.find(part)
            if node is None:
                return []
        return [type_((c.text or "").strip()) for c in node.findall(tag)]


def load_sim2d(cfg: XmlConfig):
    """Sim parameters of the 2-D sim apps (rbphdslam2dSim.cpp:94-117)."""
    from rfs_slam_tpu_torch.io.sim2d import Sim2DConfig

    return Sim2DConfig(
        timesteps=cfg.get("timesteps", 3000, int),
        dt=cfg.get("sec_per_timestep", 0.1),
        n_segments=cfg.get("trajectory.nSegments", 20, int),
        max_dx=cfg.get("trajectory.max_dx_per_sec", 0.3),
        max_dy=cfg.get("trajectory.max_dy_per_sec", 0.0),
        max_dz=cfg.get("trajectory.max_dz_per_sec", 0.5),
        min_dx=cfg.get("trajectory.min_dx_per_sec", 0.1),
        vardx=cfg.get("trajectory.vardx", 0.002),
        vardy=cfg.get("trajectory.vardy", 0.002),
        vardz=cfg.get("trajectory.vardz", 0.002),
        n_landmarks=cfg.get("landmarks.nLandmarks", 50, int),
        varlmx=cfg.get("landmarks.varlmx", 0.0002),
        varlmy=cfg.get("landmarks.varlmy", 0.0002),
        range_max=cfg.get("measurements.rangeLimitMax", 2.5),
        range_min=cfg.get("measurements.rangeLimitMin", 0.5),
        range_buffer=cfg.get("measurements.rangeLimitBuffer", 0.05),
        pd=cfg.get("measurements.probDetection", 0.99),
        clutter=cfg.get("measurements.clutterIntensity", 1e-4),
        varzr=cfg.get("measurements.varzr", 5e-4),
        varzb=cfg.get("measurements.varzb", 5e-5),
    )
