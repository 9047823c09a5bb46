"""Meshes: the port of ``repro/launch/mesh.py``.

A :class:`Mesh` holds a shape and axis names and no devices. The production
meshes are the reference's TPU pods, kept as data so that the dry run
reports the per-device shapes of their shardings.

:func:`make_local_mesh` gives a :class:`LocalMesh`: the ranks of an
initialised ``torch.distributed`` world laid out row-major over ``("data",
"model")``, as ``jax.make_mesh`` orders devices (rank ``d * model + m`` at
data index ``d``, model index ``m``), with one process group per axis line.
The model's collectives (:mod:`repro_torch.distributed.collectives`) run on
this rank's groups. A 1 x 1 mesh needs no initialised world: it is this
process alone and holds no group.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> devices along it, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


@dataclasses.dataclass(frozen=True)
class LocalMesh(Mesh):
    """A mesh of live ranks, seen from one of them: its ``rank``, its
    index along each axis (``coords``), and the process group of the line
    through it along each axis of more than one rank (``groups``)."""
    rank: int = 0
    coords: Tuple[int, ...] = ()
    groups: Dict[str, Any] = dataclasses.field(default_factory=dict,
                                               compare=False)

    def index(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 single pod (256 chips) or 2x16x16 multi-pod (512 chips)."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_local_mesh(data: int = 1, model: int = 1) -> LocalMesh:
    """A ``data`` x ``model`` mesh over the ranks of the initialised
    ``torch.distributed`` world, which must hold exactly ``data * model``
    ranks; every rank must call it, in the same order as its other group
    creations (``dist.new_group`` is collective). Raises ``ValueError``
    when the world does not match the mesh."""
    names, sizes = ("data", "model"), (data, model)
    n = data * model
    if n < 1:
        raise ValueError(f"a {data} x {model} mesh has no rank")
    import torch.distributed as dist
    if not dist.is_available() or not dist.is_initialized():
        if n == 1:
            return LocalMesh(names, sizes, 0, (0, 0))
        raise ValueError(f"a {data} x {model} mesh needs an initialised "
                         f"torch.distributed world of {n} ranks")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n:
        raise ValueError(f"a {data} x {model} mesh needs {n} ranks, the "
                         f"world has {world}")
    coords = (rank // model, rank % model)
    groups: Dict[str, Any] = {}
    # every rank creates every line's group, in the same order
    lines = {"model": [[d * model + m for m in range(model)]
                       for d in range(data)] if model > 1 else [],
             "data": [[d * model + m for d in range(data)]
                      for m in range(model)] if data > 1 else []}
    for axis in names:
        for ranks in lines[axis]:
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = g
    return LocalMesh(names, sizes, rank, coords, groups)
