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

:func:`counting_mesh` gives a live mesh of a production shape in a world of
``torch.distributed``'s ``fake`` backend, whose collectives move nothing:
the dry run counts one rank's sharded step there, on ``meta`` tensors. The
multi-pod mesh is counted as ``(data=32, model=16)``: ``pod`` is never named
without ``data`` (``mesh_rules``), so every per-device shape and every
collective's group is the same.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Iterator, Tuple, Union


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
    through it along each axis of more than one rank (``groups``), and of
    each run of ``r`` consecutive ranks of its ``model`` line through it,
    for every ``r`` that divides ``model`` (``groups["model/<r>"]``: the
    ranks sharing a replicated KV head)."""
    rank: int = 0
    coords: Tuple[int, ...] = ()
    groups: Dict[str, Any] = dataclasses.field(default_factory=dict,
                                               compare=False)

    def index(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]

    def line(self, axis: str, r: int):
        """The group of the ``r`` consecutive ranks of ``axis``'s line
        through this rank (the whole line where ``r`` is its size)."""
        if r == self.shape[axis]:
            return self.groups.get(axis)
        return self.groups.get(f"{axis}/{r}")


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 single pod (256 chips) or 2x16x16 multi-pod (512 chips)."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_local_mesh(data: int = 1, model: int = 1) -> LocalMesh:
    """A ``data`` x ``model`` mesh over the ranks of the initialised
    ``torch.distributed`` world, which must hold exactly ``data * model``
    ranks; every rank must call it, in the same order as its other group
    creations (``dist.new_group`` is collective). It creates the group of
    every line, then of every run of ``r`` consecutive ranks of each
    ``model`` line, for each ``r`` that divides ``model`` (smallest first):
    which of them a model uses depends on its KV heads, so all are made
    here, alike on every rank, before any model is built. Raises
    ``ValueError`` when the world does not match the mesh."""
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
    for r in range(2, model):
        if model % r:
            continue
        for d in range(data):
            for m0 in range(0, model, r):
                ranks = [d * model + m for m in range(m0, m0 + r)]
                g = dist.new_group(ranks)
                if rank in ranks:
                    groups[f"model/{r}"] = g
    return LocalMesh(names, sizes, rank, coords, groups)


# the (data, model) ranks a production mesh is counted on
COUNTED = {"single": (16, 16), "multi": (32, 16)}


@contextlib.contextmanager
def counting_mesh(mesh: Union[str, Tuple[int, int]],
                  rank: int = 0) -> Iterator[LocalMesh]:
    """Rank ``rank``'s :class:`LocalMesh` of ``mesh`` ("single", "multi"
    (:data:`COUNTED`) or a (data, model) shape) in a world of the ``fake``
    backend, whose collectives return at once, torn down on exit. Raises
    ``RuntimeError`` where a world is already initialised (inside a rank
    of :mod:`repro_torch.launch.spmd`)."""
    import torch.distributed as dist
    # registers the fake backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    data, model = COUNTED[mesh] if isinstance(mesh, str) else mesh
    if dist.is_initialized():
        raise RuntimeError("a counting mesh needs a process of its own: a "
                           "torch.distributed world is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=data * model)
    try:
        yield make_local_mesh(data, model)
    finally:
        dist.destroy_process_group()
