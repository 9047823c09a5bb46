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
name), the mesh axes (a tuple of names) or None. The port runs on one card,
so nothing here places a tensor: the specs give the per-device shapes the
dry run reports (:func:`shard_shape`). The reference's distribution modes
(``tp_sp``, ``tp_sp_opt``, ``fsdp_cp``) and its activation constraints
(``ShardingCtx.cs``) have no counterpart: the modes differ only in those
constraints, which place activations on a mesh the port does not run on.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

from repro_torch.launch.mesh import Mesh

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
    """The reference's sharding context, as data. ``spec(*axes, dims=)``
    gives the partition spec of logical ``axes``, dropping an axis whose
    mesh extent does not divide its dim (batch 1 long-context decode)."""
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


def param_shardings(mesh: Optional[Mesh], defs):
    """Partition-spec tree for a ``param_specs`` tree."""
    from repro_torch.models.common import pspec_tree
    return pspec_tree(defs, mesh_rules(mesh))
