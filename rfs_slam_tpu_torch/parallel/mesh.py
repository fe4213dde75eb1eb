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

``parallel/dryrun.py`` drives the apps' paths sharded and holds them to the
unsharded run.
"""

from __future__ import annotations

import dataclasses
import datetime

import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from rfs_slam_tpu_torch.core.state import (PARTICLE_AXIS_KEY, map_rows,
                                           pack_rows, unpack_rows)

PARTICLE_AXIS = "particles"
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
        if axis:
            return self.all_gather(x.movedim(axis, 0)).movedim(0, axis)
        x = x.contiguous()
        self.stats["collectives"] += 1
        if self.group is None:
            out = x
        else:
            out = x.new_empty((self.world * x.shape[0],) + x.shape[1:])
            _all_gather_tensor(out, x, group=self.group)
        self.stats["bytes"] += out.numel() * out.element_size()
        return out

    def randn_block(self, gen: torch.Generator, cols: int,
                    dtype=torch.float32) -> torch.Tensor:
        """This rank's block of a ``[p_global, cols]`` standard-normal draw
        from ``gen``: the draw the unsharded run takes."""
        return self.block(torch.randn((self.p_global, cols), generator=gen,
                                      dtype=dtype, device=self.device))


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


def particle_sharding(mesh: ParticleMesh) -> tuple:
    """Placements of an array split on its leading (particle) axis."""
    return (Shard(0),)


def replicated(mesh: ParticleMesh) -> tuple:
    """Placements of an array every rank holds whole."""
    return (Replicate(),)


def state_shardings(tree, mesh: ParticleMesh | None = None):
    """``tree`` (a state dataclass) with each tensor field replaced by its
    placements: ``(Shard(axis),)`` for a field that declares its particle
    axis (``core/state.rows``), ``(Replicate(),)`` for any other.

    The axis comes from the field's declaration, never from its shape:
    ``last_z [Zc, DZ]`` stays whole when Zc equals P.
    """
    changes = {}
    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        if dataclasses.is_dataclass(v):
            changes[f.name] = state_shardings(v, mesh)
        else:
            axis = f.metadata.get(PARTICLE_AXIS_KEY)
            changes[f.name] = (Replicate(),) if axis is None else (
                Shard(axis),)
    return dataclasses.replace(tree, **changes)


def shard_state(tree, mesh: ParticleMesh):
    """This rank's block of a whole state: each per-particle field cut to
    the rank's rows (contiguous), the other fields kept."""
    return map_rows(lambda x, axis: mesh.block(x, axis).contiguous(), tree)


def gather_state(tree, mesh: ParticleMesh):
    """The whole state from every rank's block, on every rank: the
    per-particle fields packed, all-gathered once and unpacked."""
    buf, layout = pack_rows(tree)
    return unpack_rows(mesh.all_gather(buf), layout, tree)
