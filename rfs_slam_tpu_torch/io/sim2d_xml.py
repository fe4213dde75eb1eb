"""Reference-format XML configs for the 2-D simulation apps, written in code.

The reference's ``cfg/rbphdslam2dSim.xml``, ``cfg/fastslam2dSim.xml`` and
``cfg/mhfastslam2dSim.xml`` are not in the repository.  :func:`write_config`
writes a stand-in with every key the apps read (``io/xmlconfig.py::
load_sim2d`` and each app's ``build_filter_from_xml``), set to the value the
apps fall back to when the key is absent; ``overrides`` replaces any of
them.  ``mhfastslam`` differs from ``fastslam`` only in
``filter.update.maxNDataAssocHypotheses`` (3), as the reference's two files
do.  ``filter.resampling.effNParticle`` is left out: its fallback is the
particle count, which ``--particles`` may change.

Usage::

    python -m rfs_slam_tpu_torch.io.sim2d_xml --kind fastslam --out f.xml
"""

from __future__ import annotations

import argparse
import xml.etree.ElementTree as ET

SIM_KEYS = {
    "timesteps": 3000,
    "sec_per_timestep": 0.1,
    "trajectory.nSegments": 20,
    "trajectory.max_dx_per_sec": 0.3,
    "trajectory.max_dy_per_sec": 0.0,
    "trajectory.max_dz_per_sec": 0.5,
    "trajectory.min_dx_per_sec": 0.1,
    "trajectory.vardx": 0.002,
    "trajectory.vardy": 0.002,
    "trajectory.vardz": 0.002,
    "landmarks.nLandmarks": 50,
    "landmarks.varlmx": 0.0002,
    "landmarks.varlmy": 0.0002,
    "measurements.rangeLimitMax": 2.5,
    "measurements.rangeLimitMin": 0.5,
    "measurements.rangeLimitBuffer": 0.05,
    "measurements.probDetection": 0.99,
    "measurements.clutterIntensity": 0.0001,
    "measurements.varzr": 0.0005,
    "measurements.varzb": 0.00005,
    "logging.logResultsToFile": 0,
}

_COMMON = {
    "filter.nParticles": 200,
    "filter.predict.processNoiseInflationFactor": 1.0,
    "filter.update.measurementNoiseInflationFactor": 1.0,
    "filter.update.KalmanFilter.innovationThreshold.range": -1.0,
    "filter.update.KalmanFilter.innovationThreshold.bearing": -1.0,
    "filter.resampling.minTimesteps": 1,
}

FILTER_KEYS = {
    "rbphd": {
        **_COMMON,
        "filter.predict.birthGaussianWeight": 0.01,
        "filter.update.GaussianCreateInnovMDThreshold": 0.2,
        "filter.weighting.nEvalPt": 15,
        "filter.weighting.minWeight": 0.75,
        "filter.weighting.threshold": 3.0,
        "filter.weighting.useClusterProcess": 0,
        "filter.merge.threshold": 0.5,
        "filter.merge.covInflationFactor": 1.0,
        "filter.prune.threshold": 0.01,
        "logging.logDirPrefix": "data/rbphdslam",
    },
    "fastslam": {
        **_COMMON,
        "filter.update.maxNDataAssocHypotheses": 1,
        "filter.update.maxDataAssocLogLikelihoodDiff": 3.0,
        "filter.weighting.minLogMeasurementLikelihood": -10.0,
        "filter.prune.threshold": -5.0,
        "logging.logDirPrefix": "data/fastslam",
    },
}
FILTER_KEYS["mhfastslam"] = {
    **FILTER_KEYS["fastslam"],
    "filter.update.maxNDataAssocHypotheses": 3,
    "logging.logDirPrefix": "data/mhfastslam",
}


def write_config(path: str, kind: str = "fastslam",
                 overrides: dict | None = None) -> str:
    """Write the stand-in config of ``kind`` (``rbphd``, ``fastslam`` or
    ``mhfastslam``) to ``path``; ``overrides`` maps dotted keys to values.
    Returns ``path``."""
    keys = {**SIM_KEYS, **FILTER_KEYS[kind], **(overrides or {})}
    root = ET.Element("config")
    for dotted, value in keys.items():
        node = root
        for part in dotted.split("."):
            child = node.find(part)
            node = child if child is not None else ET.SubElement(node, part)
        node.text = str(value)
    ET.indent(root)
    ET.ElementTree(root).write(path, encoding="unicode")
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kind", choices=sorted(FILTER_KEYS), default="fastslam")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    print(write_config(args.out, args.kind))


if __name__ == "__main__":
    main()
