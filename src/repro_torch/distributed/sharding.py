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

The attention's leaves are cut by whole heads (:func:`head_layout`), which
a context given the config's ``heads`` applies in :meth:`ShardingCtx.
local_block`: where ``model`` does not exceed the KV heads, in equal blocks,
as their specs cut them; where it does, each KV head is replicated over the
``model / Hkv`` consecutive ranks whose query heads read it (Megatron's
answer), and its group's query heads split over those ranks, the first ones
holding one more where they do not split evenly. The reference's GSPMD cuts
the flattened ``Hkv * hd`` columns instead; the partition specs stay its.

The reference's three distribution modes (``ShardingCtx.mode``; the
parameters are split alike in all three):

* ``tp_sp`` (the default): Megatron tensor parallelism with ZeRO-3
  weights, activations whole over ``model`` between the layers'
  all-reduces, the attention's leaves cut by the head layout above, the
  decode cache split by KV heads.
* ``tp_sp_opt``: ``tp_sp`` with Megatron sequence parallelism in prefill
  (``S > 1``): each ``model`` rank holds its ``S / tp`` rows of the
  residual, the normed rows are all-gathered before attention and the FFN
  and the partial sums reduce-scattered after them. Decode is ``tp_sp``'s.
* ``fsdp_cp``: ZeRO-3 with context parallelism. Prefill keeps the residual
  split by batch and sequence, gathers each layer's weights whole, and
  attends the rank's queries over K/V rows gathered along the sequence. A
  decode step is weight-stationary: the ``[B, 1, D]`` activations are split
  ``D`` over ``data`` to meet the weights' blocks, and the decode cache is
  split by sequence (``kv_sp``). Heads are not cut by the head layout: the
  leaves are the partition specs' equal blocks.

The reference's activation constraints (``ShardingCtx.cs``) have no
counterpart: the modes' collectives are explicit calls
(:mod:`repro_torch.models.layers`, :mod:`repro_torch.models.moe`,
:mod:`repro_torch.models.transformer`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.launch.mesh import LocalMesh, Mesh

PSpec = Tuple[Any, ...]

# the reference's distribution modes (``repro/distributed/sharding.py``)
MODES = ("tp_sp", "tp_sp_opt", "fsdp_cp")


# the attention leaves cut by the head layout: query-head columns (and
# ``wo``'s rows) and KV-head columns, in self-attention, cross-attention
# and the encoder's attention alike
Q_LEAVES = ("wq", "bq", "wo")
KV_LEAVES = ("wk", "wv", "bk", "bv")


def head_leaf(name: str) -> Optional[str]:
    """``"q"`` or ``"kv"`` for a leaf the head layout cuts (its path ends
    in ``attn/<leaf>`` or ``cross/<leaf>``), else None."""
    parts = name.strip("/").split("/")
    if len(parts) < 2 or parts[-2] not in ("attn", "cross"):
        return None
    return ("q" if parts[-1] in Q_LEAVES
            else "kv" if parts[-1] in KV_LEAVES else None)


@dataclasses.dataclass(frozen=True)
class HeadBlock:
    """One rank's heads: query heads ``q[0] .. q[1]-1``, KV heads ``kv[0]
    .. kv[1]-1``, each KV head held by ``replicas`` ranks of the line."""
    q: Tuple[int, int]
    kv: Tuple[int, int]
    replicas: int = 1


def head_layout(n_heads: int, n_kv_heads: int, tp: int,
                index: int) -> HeadBlock:
    """The heads of rank ``index`` of a ``model`` line of ``tp`` ranks.
    Where ``tp`` divides the KV heads, equal blocks of both. Where ``tp`` is
    a multiple of them, the ``r = tp / Hkv`` consecutive ranks of KV group
    ``g`` each hold KV head ``g``, and the group's ``H / Hkv`` query heads
    are split over them in ``torch.tensor_split`` order (the first ranks one
    more): rank 0 holds a largest block. Raises ``ValueError`` naming
    ``layers/*/attn/wq`` (the cross layers' and the encoder's heads are
    the same) for more ranks than heads, or where neither of ``tp`` and
    the KV heads divides the other."""
    H, Hkv = n_heads, n_kv_heads
    if Hkv % tp == 0:
        n, m = H // tp, Hkv // tp
        return HeadBlock((index * n, (index + 1) * n),
                         (index * m, (index + 1) * m))
    if tp > H or tp % Hkv:
        why = ("" if tp > H else ": neither of the ranks and the KV heads "
               "divides the other")
        raise ValueError(f"layers/*/attn/wq: {H} heads ({Hkv} KV heads) do "
                         f"not split over mesh axis 'model' of {tp} ranks"
                         f"{why}")
    r = tp // Hkv
    g, j = divmod(index, r)
    G = H // Hkv
    sizes = [G // r + (i < G % r) for i in range(r)]
    lo = g * G + sum(sizes[:j])
    return HeadBlock((lo, lo + sizes[j]), (g, g + 1), r)


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
    ``live``: it knows this rank's position and process groups, and, given
    the config's ``heads`` (query heads, KV heads), its block of them
    (:attr:`head_block`) and the line of ranks that share its KV heads,
    the logical axis ``"kv"``. ``mode`` is one of :data:`MODES`; another
    name raises ``ValueError``."""
    mesh: Optional[Mesh] = None
    heads: Optional[Tuple[int, int]] = None
    mode: str = "tp_sp"

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"sharding mode {self.mode!r}: one of {MODES}")
        self.rules = mesh_rules(self.mesh)
        self.head_block = None
        if self.live and self.heads and self.heads[1]:
            self.head_block = head_layout(*self.heads, self.axis_size("tp"),
                                          self.index("tp"))

    @property
    def kv_replicas(self) -> int:
        """The ranks of the ``model`` line that hold this rank's KV heads."""
        return self.head_block.replicas if self.head_block else 1

    @property
    def enabled(self) -> bool:
        return self.mesh is not None and self.mesh.size > 1

    def axis_size(self, logical: Optional[str]) -> int:
        if not self.enabled or logical is None:
            return 1
        if logical == "kv":
            return self.kv_replicas
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
        if logical == "kv":
            return self.mesh.line("model", self.kv_replicas)
        return self.mesh.groups.get(self._axis(logical))

    def index(self, logical: Optional[str]) -> int:
        """This rank's position along ``logical``'s mesh axis (along the
        ranks sharing its KV heads for ``"kv"``)."""
        if logical == "kv":
            return self.index("tp") % self.kv_replicas
        if not self.live or logical is None or self.rules.get(logical) is None:
            return 0
        return self.mesh.index(self._axis(logical))

    def block_slices(self, shape: Sequence[int], spec: PSpec,
                     name: str = "tensor") -> Tuple[Tuple[int, int], ...]:
        """Per dim, the ``[lo, hi)`` of this rank's block of a whole tensor
        of ``shape`` under ``spec``: each dim cut into equal blocks over its
        entry's mesh axis, but the ``model`` dim of an attention leaf
        (:func:`head_leaf` of ``name``), which holds the rank's heads of
        :attr:`head_block`. Raises ``ValueError`` naming ``name`` where an
        axis does not divide its dim."""
        spec = tuple(spec)[:len(shape)]
        spec += (None,) * (len(shape) - len(spec))
        kind = head_leaf(name) if self.head_block else None
        out = []
        for dim, (n, entry) in enumerate(zip(shape, spec)):
            k = axes_size(self.mesh, entry) if self.live else 1
            if kind is not None and entry == self.rules["tp"]:
                lo, hi = getattr(self.head_block, kind)
                per = n // self.heads[kind == "kv"]
                out.append((lo * per, hi * per))
            elif k == 1:
                out.append((0, n))
            elif n % k:
                raise ValueError(
                    f"{name}: dim {dim} of {tuple(shape)} does not split "
                    f"over mesh axis {entry!r} of {k} ranks")
            else:
                i = self.mesh.index(entry)
                out.append((i * n // k, (i + 1) * n // k))
        return tuple(out)

    def local_block(self, t: torch.Tensor, spec: PSpec,
                    name: str = "tensor") -> torch.Tensor:
        """This rank's block of the whole tensor ``t`` under ``spec``
        (:meth:`block_slices`), a copy of its own; ``t`` itself where no dim
        is cut. Raises ``ValueError`` naming ``name`` where an axis does not
        divide its dim."""
        if not self.live:
            return t
        out = t
        for dim, (lo, hi) in enumerate(self.block_slices(t.shape, spec,
                                                         name)):
            if hi - lo != t.shape[dim]:
                out = out.narrow(dim, lo, hi - lo)
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
    each in the mesh's order, and the ranks of the ``model`` line that hold
    each of its blocks (``shared``: a KV block replicated over ``model /
    Hkv`` ranks, :func:`head_layout`)."""
    split: Tuple[str, ...] = ()
    replicated: Tuple[str, ...] = ()
    shared: int = 1


def placements(pspecs, mesh: Optional[Mesh], kv_replicas: int = 1,
               name: str = ""):
    """The :class:`Placement` of every leaf of a partition-spec tree (a
    spec is a tuple of entries, a tree dicts and lists of specs) on
    ``mesh``: a leaf is split over each mesh axis its spec names, and
    replicated over the mesh's other axes of more than one rank. A KV
    leaf (:func:`head_leaf`) is shared by ``kv_replicas`` ranks of the
    ``model`` line. Without a mesh every leaf is a Placement of no axis.

    The optimizer counts a leaf's squares once across its replicas (the
    global grad norm), sums the gradients of a leaf replicated over
    ``data`` (each data rank saw its own rows), and takes a leaf's max
    over the ranks that split it (the int8 compression's scale: the max
    of a shared block's replicas is the block's)."""
    if isinstance(pspecs, tuple):
        if mesh is None:
            return Placement()
        named = set()
        for entry in pspecs:
            if entry is not None:
                named.update((entry,) if isinstance(entry, str) else entry)
        big = [a for a, n in zip(mesh.axis_names, mesh.axis_sizes) if n > 1]
        shared = kv_replicas if head_leaf(name) == "kv" else 1
        return Placement(tuple(a for a in big if a in named),
                         tuple(a for a in big if a not in named), shared)
    if isinstance(pspecs, dict):
        return {k: placements(v, mesh, kv_replicas, f"{name}/{k}")
                for k, v in pspecs.items()}
    return [placements(v, mesh, kv_replicas, f"{name}/{i}")
            for i, v in enumerate(pspecs)]


def param_shardings(mesh: Optional[Mesh], defs):
    """Partition-spec tree for a ``param_specs`` tree."""
    from repro_torch.models.common import pspec_tree
    return pspec_tree(defs, mesh_rules(mesh))
