"""Carry state, models and configuration between the JAX package and this
port, as numpy arrays.

:func:`from_numpy` builds any of the port's dataclasses from an object with
the same attribute names: a JAX ``RBPHDState``, ``FastSLAMState``,
``GMState``, model, ``RBPHDConfig`` or ``FastSLAMConfig`` (its leaves
converted with ``np.asarray``), or a nested dict made by :func:`to_numpy`.  Attributes the port does not have (the JAX
particle key, TPU-only config knobs) are ignored.  This module imports no
JAX: it reads attributes only.
"""

from __future__ import annotations

import dataclasses
import types
import typing

import numpy as np
import torch

from rfs_slam_tpu_torch.filters.fastslam import FastSLAMConfig, FastSLAMFilter
from rfs_slam_tpu_torch.filters.rbphd import RBPHDConfig, RBPHDFilter
from rfs_slam_tpu_torch.models.measurement import RangeBearing
from rfs_slam_tpu_torch.models.motion import (Ackerman2D, Odometry2D,
                                              StaticLandmark)
from rfs_slam_tpu_torch.models.victoria_park import VictoriaPark
from rfs_slam_tpu_torch.ops.ekf import InnovationGates


def _get(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def from_numpy(cls, obj, device: torch.device):
    """Port dataclass ``cls`` from ``obj`` (see module doc)."""
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        v = _get(obj, f.name)
        t = hints[f.name]
        if typing.get_origin(t) in (typing.Union, types.UnionType):
            if v is None:          # an optional field left unset
                kwargs[f.name] = None
                continue
            t = next(a for a in typing.get_args(t) if a is not type(None))
        if dataclasses.is_dataclass(t):
            kwargs[f.name] = from_numpy(t, v, device)
        elif t is torch.Tensor:
            a = np.array(v)
            if a.dtype == np.float64:   # JAX computes these in float32
                a = a.astype(np.float32)
            kwargs[f.name] = torch.as_tensor(a, device=device)
        elif t is tuple:
            kwargs[f.name] = tuple(np.asarray(v).tolist())
        else:
            kwargs[f.name] = t(np.asarray(v).item())
    return cls(**kwargs)


def to_numpy(obj):
    """Port dataclass -> nested dict of numpy arrays (tensors moved to the
    host); non-tensor fields are kept as they are."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = to_numpy(v)
        elif isinstance(v, torch.Tensor):
            out[f.name] = v.detach().cpu().numpy()
        else:
            out[f.name] = v
    return out


# the port's model for each of the JAX package's, by class name
MODELS = {cls.__name__: cls for cls in (Odometry2D, Ackerman2D,
                                        StaticLandmark, RangeBearing,
                                        VictoriaPark)}


# the port's filter (and its config) for each of the JAX package's
FILTERS = {"RBPHDFilter": (RBPHDFilter, RBPHDConfig),
           "FastSLAMFilter": (FastSLAMFilter, FastSLAMConfig)}


def filter_from_numpy(filt, device: torch.device):
    """The port's filter wired like ``filt``, the JAX package's
    ``RBPHDFilter`` or ``FastSLAMFilter`` with the 2-D simulation's models
    (Odometry2D, StaticLandmark, RangeBearing) or Victoria Park's
    (Ackerman2D, StaticLandmark with per-dt^2 noise, VictoriaPark)."""
    def model(m):
        return from_numpy(MODELS[type(m).__name__], m, device)

    cls, cfg_cls = FILTERS[type(filt).__name__]
    return cls(
        model(filt.motion), model(filt.lmk), model(filt.meas),
        from_numpy(InnovationGates, filt.gates, device),
        from_numpy(cfg_cls, filt.cfg, device),
    )
