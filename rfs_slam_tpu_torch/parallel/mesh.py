"""Particle-axis sharding over ranks on ``torch.distributed`` (port of the
JAX package's ``parallel/mesh.py``).

The reference parallelises over particles with OpenMP threads in shared
memory (RBPHDFilter.hpp:469-520).  Here one process per device holds a
contiguous block of the particle axis of every state array, and every
per-particle phase (births, predict, the map update and its kernel,
importance weighting, merge, prune) runs unchanged on the block: the
kernels launch one CTA per particle, so they take the block as it is.  The
algorithm needs two collectives a step, both in ``ops/resample.py``:

* the weights: the ``[P_local]`` log-weights are all-gathered into the
  global ``[P]`` on every rank, and normalisation, the ESS gate and the
  systematic comb run on it as on one device (an all-reduce inside
  logsumexp would sum in another order, and a slot at a cumulative-weight
  boundary could flip);
* the ancestor gather: every per-particle field is packed into one
  ``[P_local, bytes]`` buffer (``core/state.pack_rows``), all-gathered, and
  each rank keeps the rows of its block of the global ancestors.

Draws are sharding-invariant: every rank seeds its generator alike, draws
the whole ``[P, ...]`` noise and keeps its block (:meth:`ParticleMesh.
randn_block`), so a sharded run takes the unsharded run's numbers.

The ancestor gather receives the whole packed state, ``[P_global, bytes]``,
on every rank each step: a rank's memory grows with the global particle
count, so sharding spreads the per-particle work but not the state's size.

A 2-D mesh (:func:`make_mesh_2d`, :class:`MapMesh`) also splits each
particle's map: ranks ``(a, b)`` of an ``A x B`` grid hold particle block
``a`` and, of the map's fields (declared in ``core/state.py``), slot block
``b``; every other per-particle field is the same on the ``B`` ranks of a
particle block.  The particle collectives above run over the particle group
(the ranks of one slot block), so the packed rows carry a rank's map block.
The cross-slot steps of RB-PHD's update (``filters/rbphd.py``) run over the
map group (the ranks of one particle block): the map update's column sums
and picks (``ops/kernels/map_update2d.py``'s block form), the eval points
and intensity sums of importance weighting, and the map gathered whole for
the steps over a global slot order (births' and new Gaussians'
``replace_weakest``, merge).  The gathered map takes any capacity: past
1,024 slots the kernels run their large forms.

``parallel/dryrun.py`` drives the apps' paths sharded and holds them to the
unsharded run.
"""

from __future__ import annotations

import dataclasses
import datetime

import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from rfs_slam_tpu_torch.core.state import (MAP_AXIS_KEY, PARTICLE_AXIS_KEY,
                                           GMState, map_axes, pack_rows,
                                           unpack_rows)

PARTICLE_AXIS = "particles"
MAP_AXIS = "map"
# a rank that does not reach a collective fails the run after this long
GROUP_TIMEOUT_S = 120
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _init_method(coordinator: str) -> str:
    """``host:port`` -> ``tcp://host:port``; a URL (``file://...``) as is."""
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def init_process_group(coordinator: str, num_processes: int,
                       process_id: int, device: torch.device,
                       backend: str | None = None) -> None:
    """``torch.distributed.init_process_group`` with a finite timeout, for
    any number of processes.  The backend is the one of ``device``'s type
    (cuda: NCCL, cpu: gloo) unless the caller names one: never what
    happens to be available."""
    device = torch.device(device)
    if device.type not in BACKENDS:
        raise ValueError(f"no collective backend for device {device}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend or BACKENDS[device.type],
        init_method=_init_method(coordinator),
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *,
                     device: torch.device) -> None:
    """Join the process group of a multi-process run (a no-op for one
    process).  ``coordinator``: ``host:port`` of rank 0 (TCP) or a
    ``file://`` rendezvous path."""
    if num_processes and num_processes > 1:
        init_process_group(coordinator, num_processes, process_id, device)


_all_gather_tensor = (getattr(dist, "all_gather_single", None)
                      or dist.all_gather_into_tensor)


@dataclasses.dataclass(frozen=True)
class ParticleMesh:
    """A 1-D mesh over the ranks and this rank's block of the particle
    axis: rows ``offset .. offset + p_local`` of ``p_global``.

    ``group`` is the mesh axis's process group (None: one process, no
    collectives); ``stats`` counts the collectives and the bytes each rank
    received from them.
    """

    world: int
    rank: int
    p_global: int
    device: torch.device
    group: object = None
    stats: dict = dataclasses.field(
        default_factory=lambda: {"collectives": 0, "bytes": 0})

    @property
    def p_local(self) -> int:
        return self.p_global // self.world

    @property
    def offset(self) -> int:
        return self.rank * self.p_local

    def block(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """This rank's rows of a global ``x`` along ``axis``."""
        return x.narrow(axis, self.offset, self.p_local)

    def all_gather(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """Every rank's block of ``x`` along ``axis``, in rank order, on
        every rank: one collective."""
        return self._gather(x, axis, self.group, self.world)

    def _gather(self, x, axis, group, world):
        if axis:
            return self._gather(x.movedim(axis, 0), 0, group,
                                world).movedim(0, axis)
        x = x.contiguous()
        self.stats["collectives"] += 1
        if group is None:
            out = x
        else:
            out = x.new_empty((world * x.shape[0],) + x.shape[1:])
            _all_gather_tensor(out, x, group=group)
        self.stats["bytes"] += out.numel() * out.element_size()
        return out

    def randn_block(self, gen: torch.Generator, cols: int,
                    dtype=torch.float32) -> torch.Tensor:
        """This rank's block of a ``[p_global, cols]`` standard-normal draw
        from ``gen``: the draw the unsharded run takes."""
        return self.block(torch.randn((self.p_global, cols), generator=gen,
                                      dtype=dtype, device=self.device))


@dataclasses.dataclass(frozen=True)
class MapMesh(ParticleMesh):
    """A 2-D particles x map mesh: this rank holds particle rows ``offset ..
    offset + p_local`` of ``p_global`` and, of the map's fields, slots
    ``m_offset .. m_offset + m_local`` of ``m_global``.

    As a :class:`ParticleMesh` it is the particle axis (``world``,
    ``rank``, ``group``: the ranks of this rank's slot block), so the
    resampling collectives run on it unchanged; ``map_world``,
    ``map_rank`` and ``map_group`` are the map axis (the ranks of this
    rank's particle block).  A 1 x 1 mesh is the unsharded run's layout.
    """

    m_global: int = 0
    map_world: int = 1
    map_rank: int = 0
    map_group: object = None

    @property
    def m_local(self) -> int:
        return self.m_global // self.map_world

    @property
    def m_offset(self) -> int:
        return self.map_rank * self.m_local

    def map_block(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        """This rank's slots of a whole-map ``x`` along ``axis``."""
        return x.narrow(axis, self.m_offset, self.m_local)

    def map_all_gather(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """Every map rank's ``x`` along ``axis``, in rank order, on every
        rank of the map group: one collective."""
        return self._gather(x, axis, self.map_group, self.map_world)

    def gather_blocks(self, tensors: dict) -> dict:
        """``{name: x}`` of this rank's particles (leading axis ``P_local``)
        -> ``{name: [map_world, P_local, ...]}``: every map rank's ``x`` in
        rank order, packed into one buffer and gathered in one
        collective."""
        buf, layout = pack_rows(tensors)
        whole = unpack_rows(self.map_all_gather(buf), layout, tensors)
        return {k: v.view((self.map_world,) + tensors[k].shape)
                for k, v in whole.items()}

    def gather_slots(self, tensors: dict) -> dict:
        """``{name: (x, slot axis)}`` -> ``{name: whole x}``: every map
        rank's slots, packed into one buffer (a row a slot) and gathered
        in one collective, each tensor contiguous."""
        moved = {k: x.movedim(ax, 0) for k, (x, ax) in tensors.items()}
        buf, layout = pack_rows(moved)
        whole = unpack_rows(self.map_all_gather(buf), layout, moved)
        return {k: whole[k].movedim(0, ax).contiguous()
                for k, (_, ax) in tensors.items()}

    def gather_map(self, gm: GMState) -> GMState:
        """The whole map of this rank's particles from every map rank's
        block (one collective)."""
        return GMState(**self.gather_slots(_map_fields(gm)))

    def map_block_gm(self, gm: GMState) -> GMState:
        """This rank's slot block of a whole map."""
        return GMState(**{k: self.map_block(x, ax).contiguous()
                          for k, (x, ax) in _map_fields(gm).items()})


def _map_fields(gm: GMState) -> dict:
    """``{field: (tensor, slot axis)}`` of a map."""
    return {f.name: (getattr(gm, f.name), f.metadata[MAP_AXIS_KEY])
            for f in dataclasses.fields(gm)}


def make_mesh(n_particles: int, device: torch.device) -> ParticleMesh:
    """The 1-D particle mesh over the process group's ranks
    (``init_device_mesh``), or one rank without a process group.  Raises
    when ``n_particles`` does not split evenly."""
    device = torch.device(device)
    world, rank, group = 1, 0, None
    if dist.is_available() and dist.is_initialized():
        from torch.distributed.device_mesh import init_device_mesh

        world, rank = dist.get_world_size(), dist.get_rank()
        group = init_device_mesh(device.type, (world,),
                                 mesh_dim_names=(PARTICLE_AXIS,)).get_group(
                                     PARTICLE_AXIS)
    if n_particles % world:
        raise ValueError(f"{n_particles} particles do not split over "
                         f"{world} ranks")
    return ParticleMesh(world, rank, n_particles, device, group)


def make_mesh_2d(n_particle_shards: int, n_map_shards: int,
                 n_particles: int, map_capacity: int,
                 device: torch.device) -> MapMesh:
    """The ``A x B`` particles x map mesh over the process group's ranks
    (``init_device_mesh`` with dimensions ``("particles", "map")``; rank
    ``a * B + b`` holds particle block ``a`` and slot block ``b``), or the
    1 x 1 mesh without a process group.  Raises when the ranks are not ``A
    * B``, ``n_particles`` does not split over ``A`` or ``map_capacity``
    over ``B``."""
    device = torch.device(device)
    A, B = n_particle_shards, n_map_shards
    world, groups, coords = 1, (None, None), (0, 0)
    if dist.is_available() and dist.is_initialized():
        from torch.distributed.device_mesh import init_device_mesh

        world = dist.get_world_size()
        if world == A * B:
            dm = init_device_mesh(device.type, (A, B),
                                  mesh_dim_names=(PARTICLE_AXIS, MAP_AXIS))
            groups = (dm.get_group(PARTICLE_AXIS), dm.get_group(MAP_AXIS))
            coords = (dm.get_local_rank(PARTICLE_AXIS),
                      dm.get_local_rank(MAP_AXIS))
    if world != A * B:
        raise ValueError(f"a {A} x {B} mesh needs {A * B} ranks, the group "
                         f"has {world}")
    if n_particles % A:
        raise ValueError(f"{n_particles} particles do not split over {A} "
                         f"particle blocks")
    if map_capacity % B:
        raise ValueError(f"{map_capacity} map slots do not split over {B} "
                         f"map blocks")
    return MapMesh(A, coords[0], n_particles, device, groups[0],
                   m_global=map_capacity, map_world=B, map_rank=coords[1],
                   map_group=groups[1])


def particle_sharding(mesh: ParticleMesh) -> tuple:
    """Placements of an array split on its leading (particle) axis."""
    return (Shard(0),)


def replicated(mesh: ParticleMesh) -> tuple:
    """Placements of an array every rank holds whole."""
    return (Replicate(),)


def _placements(tree, place):
    """``tree`` with each tensor field replaced by ``place(particle axis,
    map axis)`` (None for an axis the field does not declare)."""
    changes = {}
    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        changes[f.name] = (_placements(v, place) if dataclasses.is_dataclass(v)
                           else place(f.metadata.get(PARTICLE_AXIS_KEY),
                                      f.metadata.get(MAP_AXIS_KEY)))
    return dataclasses.replace(tree, **changes)


def _axis(axis):
    return Replicate() if axis is None else Shard(axis)


def state_shardings(tree, mesh: ParticleMesh | None = None):
    """``tree`` (a state dataclass) with each tensor field replaced by its
    placements: ``(Shard(axis),)`` for a field that declares its particle
    axis (``core/state.rows``), ``(Replicate(),)`` for any other.

    The axis comes from the field's declaration, never from its shape:
    ``last_z [Zc, DZ]`` stays whole when Zc equals P.
    """
    return _placements(tree, lambda axis, _: (_axis(axis),))


def state_shardings_2d(tree, mesh: MapMesh | None = None):
    """``tree`` with each tensor field replaced by its placements on the
    ``("particles", "map")`` mesh: ``(Shard(axis), Shard(map_axis))`` for
    a map field, ``(Shard(axis), Replicate())`` for any other per-particle
    field, ``(Replicate(), Replicate())`` for the rest.

    Both axes come from the fields' declarations, never from shapes: a
    ``[P, Zc]`` field stays whole over the map when Zc equals M."""
    return _placements(tree, lambda axis, map_axis: (_axis(axis),
                                                     _axis(map_axis)))


def shard_state(tree, mesh: ParticleMesh):
    """This rank's block of a whole state: each per-particle field cut to
    the rank's rows and, under a :class:`MapMesh`, each map field to the
    rank's slots (contiguous), the other fields kept."""
    slots = isinstance(mesh, MapMesh)

    def cut(x, axis, map_axis):
        x = mesh.block(x, axis)
        if slots and map_axis is not None:
            x = mesh.map_block(x, map_axis)
        return x.contiguous()

    return map_axes(cut, tree)


def gather_state(tree, mesh: ParticleMesh):
    """The whole state from every rank's block, on every rank: under a
    :class:`MapMesh` each map gathered over the map group first; then the
    per-particle fields packed, all-gathered once and unpacked."""
    if isinstance(mesh, MapMesh):
        tree = _replace_maps(tree, mesh.gather_map)
    buf, layout = pack_rows(tree)
    return unpack_rows(mesh.all_gather(buf), layout, tree)


def _replace_maps(tree, fn):
    """``tree`` with every ``GMState`` in it replaced by ``fn(gm)``."""
    if isinstance(tree, GMState):
        return fn(tree)
    return dataclasses.replace(tree, **{
        f.name: _replace_maps(getattr(tree, f.name), fn)
        for f in dataclasses.fields(tree)
        if dataclasses.is_dataclass(getattr(tree, f.name))})
