"""Logical-axis sharding rules as data: the port of
``repro/distributed/sharding.py``.

Meshes (:mod:`repro_torch.launch.mesh`):
    single-pod : (data=16, model=16)            axes ("data", "model")
    multi-pod  : (pod=2, data=16, model=16)     axes ("pod", "data", "model")

Logical axes:
    "fsdp"  -- ZeRO-3 parameter sharding over ("pod","data")
    "tp"    -- tensor parallel over "model"
    "exp"   -- expert parallel over "model"
    "batch" -- activation batch over ("pod","data")
    "sp"    -- activation sequence over "model"
    "kv_sp" -- decode KV cache sequence over "model"

A partition spec is a plain tuple with one entry per dim: the mesh axis (a
name), the mesh axes (a tuple of names) or None. On the production meshes,
which are data, the specs give the per-device shapes the dry run reports
(:func:`shard_shape`). On a live mesh
(:func:`~repro_torch.launch.mesh.make_local_mesh`) the context places
tensors: :meth:`ShardingCtx.local_block` cuts this rank's block of a
tensor, :meth:`ShardingCtx.shard_tree` a whole parameter tree, and
:meth:`ShardingCtx.group` gives the process group the model's collectives
(:mod:`repro_torch.distributed.collectives`) run on.
Where a mesh axis does not divide the dim it splits, a live mesh raises
``ValueError`` naming the leaf; the reference's partitioner pads instead.

The reference's distribution modes (``tp_sp``, ``tp_sp_opt``, ``fsdp_cp``)
and its activation constraints (``ShardingCtx.cs``) have no counterpart:
the port runs one mode, Megatron tensor parallelism with ZeRO-3 weights,
its activations replicated over ``model`` between the layers' collectives
(:mod:`repro_torch.models.layers`, :mod:`repro_torch.models.moe`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.launch.mesh import LocalMesh, Mesh

PSpec = Tuple[Any, ...]


def mesh_rules(mesh: Optional[Mesh]) -> Dict[Optional[str], Any]:
    """Map logical axes -> mesh axes for the given mesh (None => no
    sharding)."""
    if mesh is None:
        return {}
    dp: Any = ("pod", "data") if "pod" in mesh.axis_names else "data"
    return {"fsdp": dp, "batch": dp, "tp": "model", "exp": "model",
            "sp": "model", "kv_sp": "model", "stack": None, None: None}


def _divides(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def axes_size(mesh: Optional[Mesh], entry: Any) -> int:
    """Devices along one partition-spec entry (1 for None)."""
    if mesh is None or entry is None:
        return 1
    names = (entry,) if isinstance(entry, str) else entry
    return math.prod(mesh.shape[a] for a in names)


def shard_shape(mesh: Optional[Mesh], shape: Sequence[int],
                spec: PSpec) -> Tuple[int, ...]:
    """One device's block of a tensor of ``shape`` under ``spec``: each dim
    split over its entry's devices, rounded up where they do not divide
    it (the padding an SPMD partitioner adds)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(-(-n // axes_size(mesh, e)) for n, e in zip(shape, spec))


@dataclasses.dataclass
class ShardingCtx:
    """The reference's sharding context. ``spec(*axes, dims=)`` gives the
    partition spec of logical ``axes``, dropping an axis whose mesh extent
    does not divide its dim (batch 1 long-context decode). On a
    :class:`~repro_torch.launch.mesh.LocalMesh` of more than one rank it is
    ``live``: it knows this rank's position and process groups."""
    mesh: Optional[Mesh] = None

    def __post_init__(self):
        self.rules = mesh_rules(self.mesh)

    @property
    def enabled(self) -> bool:
        return self.mesh is not None and self.mesh.size > 1

    def axis_size(self, logical: Optional[str]) -> int:
        if not self.enabled or logical is None:
            return 1
        return axes_size(self.mesh, self.rules.get(logical))

    def spec(self, *axes: Optional[str],
             dims: Optional[Sequence[int]] = None) -> PSpec:
        """Partition spec for logical axes; if dims given, drop
        non-dividing axes."""
        entries = []
        for i, a in enumerate(axes):
            mesh_axes = self.rules.get(a) if self.enabled else None
            if mesh_axes is not None and dims is not None:
                if not _divides(dims[i], self.axis_size(a)):
                    mesh_axes = None
            entries.append(mesh_axes)
        return tuple(entries)

    # -- the live mesh ------------------------------------------------------
    @property
    def live(self) -> bool:
        return self.enabled and isinstance(self.mesh, LocalMesh)

    @property
    def tp_axis(self) -> Optional[str]:
        return ("model" if self.enabled and "model" in self.mesh.axis_names
                else None)

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        if not self.enabled:
            return ()
        return ("pod", "data") if "pod" in self.mesh.axis_names else ("data",)

    def _axis(self, logical: str) -> str:
        axis = self.rules[logical]
        if not isinstance(axis, str):
            raise ValueError(f"logical axis {logical!r} spans mesh axes "
                             f"{axis}; a live mesh has one per axis")
        return axis

    def group(self, logical: str):
        """The process group of the line through this rank along
        ``logical``'s mesh axis (None where that axis has one rank)."""
        if not self.live:
            return None
        return self.mesh.groups.get(self._axis(logical))

    def index(self, logical: Optional[str]) -> int:
        """This rank's position along ``logical``'s mesh axis."""
        if not self.live or logical is None or self.rules.get(logical) is None:
            return 0
        return self.mesh.index(self._axis(logical))

    def local_block(self, t: torch.Tensor, spec: PSpec,
                    name: str = "tensor") -> torch.Tensor:
        """This rank's block of the whole tensor ``t`` under ``spec``: each
        dim cut into equal blocks over its entry's mesh axis, a copy of its
        own; ``t`` itself where no dim is cut. Raises ``ValueError`` naming
        ``name`` where an axis does not divide its dim."""
        if not self.live:
            return t
        out = t
        for dim, entry in enumerate(tuple(spec)[:t.dim()]):
            n = axes_size(self.mesh, entry)
            if n == 1:
                continue
            if t.shape[dim] % n:
                raise ValueError(
                    f"{name}: dim {dim} of {tuple(t.shape)} does not split "
                    f"over mesh axis {entry!r} of {n} ranks")
            size = t.shape[dim] // n
            out = out.narrow(dim, self.mesh.index(entry) * size, size)
        return t if out is t else out.clone(
            memory_format=torch.contiguous_format)

    def shard_tree(self, tree, pspecs, name: str = ""):
        """:meth:`local_block` of every tensor of a tree (dicts and lists)
        under its partition-spec tree."""
        if isinstance(tree, torch.Tensor):
            return self.local_block(tree, pspecs, name or "tensor")
        if isinstance(tree, dict):
            return {k: self.shard_tree(v, pspecs[k], f"{name}/{k}")
                    for k, v in tree.items()}
        return [self.shard_tree(v, s, f"{name}/{i}")
                for i, (v, s) in enumerate(zip(tree, pspecs))]


# the logical axis whose line runs along each mesh axis of a live mesh
LINE = {"data": "batch", "model": "tp"}


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where one leaf lives on a live mesh: the mesh axes of more than one
    rank that cut it (``split``) and those it is whole on (``replicated``),
    each in the mesh's order."""
    split: Tuple[str, ...] = ()
    replicated: Tuple[str, ...] = ()


def placements(pspecs, mesh: Optional[Mesh]):
    """The :class:`Placement` of every leaf of a partition-spec tree (a
    spec is a tuple of entries, a tree dicts and lists of specs) on
    ``mesh``: a leaf is split over each mesh axis its spec names, and
    replicated over the mesh's other axes of more than one rank. Without a
    mesh every leaf is a Placement of no axis.

    The optimizer counts a leaf's squares once across its replicas (the
    global grad norm), sums the gradients of a leaf replicated over
    ``data`` (each data rank saw its own rows), and takes a leaf's max
    over the ranks that split it (the int8 compression's scale)."""
    if isinstance(pspecs, tuple):
        if mesh is None:
            return Placement()
        named = set()
        for entry in pspecs:
            if entry is not None:
                named.update((entry,) if isinstance(entry, str) else entry)
        big = [a for a, n in zip(mesh.axis_names, mesh.axis_sizes) if n > 1]
        return Placement(tuple(a for a in big if a in named),
                         tuple(a for a in big if a not in named))
    if isinstance(pspecs, dict):
        return {k: placements(v, mesh) for k, v in pspecs.items()}
    return [placements(v, mesh) for v in pspecs]


def param_shardings(mesh: Optional[Mesh], defs):
    """Partition-spec tree for a ``param_specs`` tree."""
    from repro_torch.models.common import pspec_tree
    return pspec_tree(defs, mesh_rules(mesh))
