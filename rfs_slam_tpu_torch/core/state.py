"""SoA state containers for the particle filter, as dataclasses of tensors.

Port of the JAX package's ``core/state.py``.  Landmark means and covariances are
plane-major: ``mean[D, P, M]``, packed symmetric ``cov[T, P, M]``
(:mod:`rfs_slam_tpu_torch.core.planar`).  Containers are immutable by
convention: phases build new ones with :func:`dataclasses.replace`.

Each per-particle field declares its particle axis (:func:`rows`: 0 for
``[P, ...]``, 1 for the plane-major ``[D|T, P, M]``); a field without one
is the same for every particle.  The map's fields (``GMState``'s) also
declare their slot axis, the axis a particles x map mesh splits.
:func:`map_rows` applies a function to the per-particle fields of a state
(:func:`map_axes` with the slot axis too), and :func:`pack_rows` /
:func:`unpack_rows` carry them as one ``[P, bytes]`` buffer, the unit the
particle-axis collectives of :mod:`rfs_slam_tpu_torch.parallel.mesh` move.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from rfs_slam_tpu_torch.core import planar

PARTICLE_AXIS_KEY = "particle_axis"
MAP_AXIS_KEY = "map_axis"
_ROW_ALIGN = 8  # bytes: every field's columns start on an int64 boundary


def rows(axis: int = 0, map_axis: int | None = None):
    """A dataclass field whose axis ``axis`` is the particle axis and, for
    a map field, whose axis ``map_axis`` is the slot axis."""
    meta = {PARTICLE_AXIS_KEY: axis}
    if map_axis is not None:
        meta[MAP_AXIS_KEY] = map_axis
    return dataclasses.field(metadata=meta)


def map_axes(fn, obj):
    """``obj`` with every per-particle tensor ``x`` replaced by ``fn(x,
    axis, map_axis)`` (``map_axis`` None for a field without a slot axis),
    the other fields kept.  ``obj`` is one of the state dataclasses (nested
    ones are walked) or a dict of them and of tensors whose leading axis is
    the particle axis.  Fields are visited in declaration order, dict
    entries in insertion order."""
    if isinstance(obj, dict):
        return {k: map_axes(fn, v) if dataclasses.is_dataclass(v)
                else fn(v, 0, None) for k, v in obj.items()}
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            changes[f.name] = map_axes(fn, v)
        elif f.metadata.get(PARTICLE_AXIS_KEY) is not None:
            changes[f.name] = fn(v, f.metadata[PARTICLE_AXIS_KEY],
                                 f.metadata.get(MAP_AXIS_KEY))
    return dataclasses.replace(obj, **changes)


def map_rows(fn, obj):
    """:func:`map_axes` with ``fn(x, axis)``: the particle axis only."""
    return map_axes(lambda x, axis, _: fn(x, axis), obj)


@dataclasses.dataclass(frozen=True)
class RowLayout:
    """Where each per-particle field of a state sits in a packed row:
    ``(byte offset, byte count, shape of one particle's entry, dtype,
    particle axis)`` per field, in :func:`map_rows` order, and the row's
    width in bytes."""

    fields: tuple
    width: int


def pack_rows(obj):
    """Every per-particle field of ``obj`` as one ``uint8 [P, width]``
    buffer, each particle's entries in one row (floats and ints by their
    bytes, bools as one byte).  Returns ``(buffer, RowLayout)``."""
    leaves, fields, off = [], [], 0

    def visit(x, axis):
        nonlocal off
        per = x.movedim(axis, 0)
        n = per[0].numel() * x.element_size()
        fields.append((off, n, tuple(per.shape[1:]), x.dtype, axis))
        leaves.append(per)
        off += -(-n // _ROW_ALIGN) * _ROW_ALIGN
        return x

    map_rows(visit, obj)
    P = leaves[0].shape[0]
    buf = torch.empty((P, off), dtype=torch.uint8, device=leaves[0].device)
    for per, (o, n, shape, _, _) in zip(leaves, fields):
        # a trailing unit axis makes the byte view legal for any strides
        buf[:, o:o + n].view((P,) + shape + (per.element_size(),)).copy_(
            per.unsqueeze(-1).view(torch.uint8))
    return buf, RowLayout(tuple(fields), off)


def unpack_rows(buf: torch.Tensor, layout: RowLayout, like):
    """The inverse of :func:`pack_rows`: ``like`` (a state of the packed
    structure, any particle count) with its per-particle fields read from
    the rows of ``buf`` ``[P', width]``, each a contiguous tensor of
    ``P'`` particles."""
    it = iter(layout.fields)

    def take(_, axis):
        o, n, shape, dtype, ax = next(it)
        assert ax == axis
        per = buf[:, o:o + n].view(dtype).view((buf.shape[0],) + shape)
        return per.movedim(0, axis).contiguous()

    return map_rows(take, like)


def _eye_planes(n_particles, capacity, dim, device, dtype):
    # filled on the device: a host tensor copied there would wait for the
    # device's queue (a run's init_state sits inside its step loop)
    return torch.stack([torch.full((n_particles, capacity),
                                   1.0 if i == j else 0.0, dtype=dtype,
                                   device=device)
                        for i in range(dim) for j in range(i, dim)])


@dataclasses.dataclass(frozen=True)
class GMState:
    """Per-particle Gaussian-mixture map, padded to capacity M.

    mean [D, P, M], cov [T, P, M] packed, w / w_prev [P, M], alive [P, M] bool.
    The slot axis M is the map axis of a particles x map mesh.
    """

    mean: torch.Tensor = rows(1, map_axis=2)
    cov: torch.Tensor = rows(1, map_axis=2)
    w: torch.Tensor = rows(0, map_axis=1)
    w_prev: torch.Tensor = rows(0, map_axis=1)
    alive: torch.Tensor = rows(0, map_axis=1)

    @classmethod
    def empty(cls, n_particles: int, capacity: int, dim: int,
              device: torch.device, dtype=torch.float32) -> "GMState":
        z = torch.zeros((n_particles, capacity), dtype=dtype, device=device)
        return cls(
            mean=torch.zeros((dim, n_particles, capacity), dtype=dtype,
                             device=device),
            cov=_eye_planes(n_particles, capacity, dim, device, dtype),
            w=z, w_prev=z.clone(),
            alive=torch.zeros((n_particles, capacity), dtype=torch.bool,
                              device=device),
        )

    @classmethod
    def from_dense(cls, mean: torch.Tensor, cov: torch.Tensor,
                   w: torch.Tensor, w_prev: torch.Tensor | None = None,
                   alive: torch.Tensor | None = None) -> "GMState":
        """From ``mean[P, M, D]`` / ``cov[P, M, D, D]`` (boundary use);
        ``w_prev`` defaults to zeros, ``alive`` to every slot."""
        return cls(mean=planar.pack_vec(mean), cov=planar.pack_sym(cov),
                   w=w, w_prev=torch.zeros_like(w) if w_prev is None
                   else w_prev,
                   alive=torch.ones(w.shape, dtype=torch.bool,
                                    device=w.device) if alive is None
                   else alive)

    @property
    def mean_dense(self) -> torch.Tensor:
        """``[P, M, D]`` (boundary use)."""
        return planar.unpack_vec(self.mean)

    @property
    def cov_dense(self) -> torch.Tensor:
        """``[P, M, D, D]`` (boundary use)."""
        return planar.unpack_sym(self.cov, self.dim)

    @property
    def n_particles(self) -> int:
        return self.w.shape[0]

    @property
    def capacity(self) -> int:
        return self.w.shape[1]

    @property
    def dim(self) -> int:
        return self.mean.shape[0]

    def count(self) -> torch.Tensor:
        return self.alive.sum(dim=-1)


@dataclasses.dataclass(frozen=True)
class BirthCandidates:
    """Birth-candidate list (RBPHDFilter.hpp:171-178): mean [D, P, C],
    cov [T, P, C], n_support / n_checks [P, C] int32, alive [P, C] bool."""

    mean: torch.Tensor = rows(1)
    cov: torch.Tensor = rows(1)
    n_support: torch.Tensor = rows(0)
    n_checks: torch.Tensor = rows(0)
    alive: torch.Tensor = rows(0)

    @classmethod
    def empty(cls, n_particles: int, capacity: int, dim: int,
              device: torch.device, dtype=torch.float32) -> "BirthCandidates":
        zi = torch.zeros((n_particles, capacity), dtype=torch.int32,
                         device=device)
        return cls(
            mean=torch.zeros((dim, n_particles, capacity), dtype=dtype,
                             device=device),
            cov=_eye_planes(n_particles, capacity, dim, device, dtype),
            n_support=zi, n_checks=zi.clone(),
            alive=torch.zeros((n_particles, capacity), dtype=torch.bool,
                              device=device),
        )

    @property
    def capacity(self) -> int:
        return self.alive.shape[1]


@dataclasses.dataclass(frozen=True)
class ParticleState:
    """pose [P, 3], log_w [P], parent [P] int64 (ancestor of the last
    resample).  Randomness comes from the caller, so no key is carried."""

    pose: torch.Tensor = rows(0)
    log_w: torch.Tensor = rows(0)
    parent: torch.Tensor = rows(0)

    @classmethod
    def init(cls, n_particles: int, pose0: torch.Tensor,
             n_live: int | None = None) -> "ParticleState":
        """``n_particles`` copies of ``pose0``.  With ``n_live`` (the
        MH-FastSLAM grow mode, FastSLAM.hpp:335), only the first
        ``n_live`` slots start live, at weight ``1 / n_live``; the others
        carry ``-inf``."""
        log_w = torch.zeros((n_particles,), dtype=pose0.dtype,
                            device=pose0.device)
        if n_live is not None and n_live != n_particles:
            live = torch.arange(n_particles, device=pose0.device) < n_live
            log_w = torch.where(live, -math.log(float(n_live)),
                                float("-inf")).to(pose0.dtype)
        return cls(
            pose=pose0.expand(n_particles, pose0.shape[-1]).contiguous(),
            log_w=log_w,
            parent=torch.arange(n_particles, device=pose0.device),
        )

    @property
    def n_particles(self) -> int:
        return self.pose.shape[0]
