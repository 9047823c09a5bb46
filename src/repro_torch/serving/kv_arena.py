"""Physical paged KV arena: the device-tensor store behind the elastic
virtual KV pool (§III.C spatial multiplexing).

The port's counterpart of ``repro/serving/kv_arena.py``. One
:class:`KVArena` owns the K/V page storage its engines decode from,
organised into *planes* — one pair of ``[n_layers, n_rows, page_tokens,
Hkv, hd]`` K and V tensors per distinct KV geometry — so models with the
same per-token KV shape interleave their pages in the same tensors. Writes
go in place (``index_put_`` and slice assignment) where the reference
rebuilds donated arrays with ``.at[].set``.

The arena never decides admission: every alloc / grow / free flows through
the engine's :class:`~repro_torch.core.runtime.kv_pool.VirtualKVPool`, and
the per-engine :class:`ModelKVBinding` mirrors the pool's page grants 1:1
onto plane rows. A row may back several mappings at once: a prefix-cache
hit aliases the rows of a cached prefix (``alloc_seq(alias_rows=)``) and
the node's :class:`~repro_torch.serving.prefix_cache.PrefixIndex` pins
them, so each row carries a reference count and a shared row is copied
on the device before any write lands on it (:meth:`ModelKVBinding.
make_private`). A model with no self-attention layer (pure SSM) gets an
accounting-only binding: its pool still grants pages, but no plane backs
them. Row 0 of every plane is the reserved *null row* that idle decode
slots and chunk pad columns point at; it is never granted.

Sizing: ``init_rows`` is the initial plane capacity; a full plane doubles
by copying, so a caller that knows its peak (a full-width model holds
~2.4 MB per row) passes it up front.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import dtype_bytes
from repro_torch.core.runtime.kv_pool import VirtualKVPool
from repro_torch.serving.prefix_cache import PrefixCacheConfig, PrefixIndex

NULL_ROW = 0


@dataclasses.dataclass(frozen=True)
class PlaneSpec:
    """KV geometry of one arena plane (the plane-sharing key)."""
    n_layers: int          # stacked self-attention layers
    page_tokens: int
    n_kv_heads: int
    head_dim: int
    dtype: torch.dtype

    @property
    def row_bytes(self) -> int:
        """Physical bytes of one K+V row (= one page across all layers)."""
        return (2 * self.n_layers * self.page_tokens * self.n_kv_heads
                * self.head_dim * dtype_bytes(self.dtype))


class ArenaPlane:
    """One geometry's physical page store: K/V tensors + a free-row list."""

    def __init__(self, spec: PlaneSpec, init_rows: int = 8, device=None):
        self.spec = spec
        n = max(2, init_rows)              # row 0 is the reserved null row
        self.k = torch.zeros(self._shape(n), dtype=spec.dtype, device=device)
        self.v = torch.zeros(self._shape(n), dtype=spec.dtype, device=device)
        self.free_rows: List[int] = list(range(n - 1, 0, -1))
        self.refs: Dict[int, int] = {}     # live row -> reference count

    def _shape(self, n_rows: int):
        s = self.spec
        return (s.n_layers, n_rows, s.page_tokens, s.n_kv_heads, s.head_dim)

    @property
    def n_rows(self) -> int:
        return self.k.shape[1]

    def take_row(self) -> int:
        if not self.free_rows:
            self._grow()
        row = self.free_rows.pop()
        self.refs[row] = 1
        return row

    def share_row(self, row: int) -> None:
        """Add a reference to a live row (prefix alias or index pin)."""
        assert row != NULL_ROW and row in self.refs
        self.refs[row] += 1

    def drop_row(self, row: int) -> None:
        """Release one reference; the row returns to the free list at zero."""
        assert row != NULL_ROW
        self.refs[row] -= 1
        if self.refs[row] == 0:
            del self.refs[row]
            self.free_rows.append(row)

    def copy_row(self, src: int) -> int:
        """Copy-on-write: a private copy of a shared row, across every
        layer, on the device. The take comes first: it may grow the plane,
        which replaces ``self.k``/``self.v``."""
        dst = self.take_row()
        self.k[:, dst] = self.k[:, src]
        self.v[:, dst] = self.v[:, src]
        return dst

    def _grow(self) -> None:
        """Double capacity by copying into new tensors: callers read
        ``plane.k``/``plane.v`` afresh after any grant."""
        old = self.n_rows
        new = old * 2
        for name in ("k", "v"):
            cur = getattr(self, name)
            grown = torch.zeros(self._shape(new), dtype=cur.dtype,
                                device=cur.device)
            grown[:, :old] = cur
            setattr(self, name, grown)
        self.free_rows.extend(range(new - 1, old - 1, -1))

    def write_prompt(self, n_layers: int, rows: np.ndarray,
                     k: torch.Tensor, v: torch.Tensor) -> None:
        """Scatter a prompt's KV into this plane in place.

        ``k``/``v`` are ``[n_layers, P, Hkv, hd]`` (layer-stacked prefill
        cache); ``rows`` the plane rows of the sequence's first
        ``ceil(P/page_tokens)`` pages.
        """
        page = self.spec.page_tokens
        P = k.shape[1]
        n = -(-P // page)
        pad = n * page - P
        if pad:
            k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
            v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        shape = (n_layers, n, page) + tuple(k.shape[2:])
        idx = torch.as_tensor(np.asarray(rows[:n], np.int64),
                              device=self.k.device)
        self.k[:n_layers, idx] = k.reshape(shape).to(self.k.dtype)
        self.v[:n_layers, idx] = v.reshape(shape).to(self.v.dtype)


class ModelKVBinding:
    """The 1:1 mirror between one engine's pool grants and arena rows: every
    pool page id maps to exactly one plane row from the moment it is granted
    until the pool unmaps it (``reclaim``); rows may be shared across
    mappings (prefix aliases). ``plane`` is None for a model with nothing
    to page: then no page maps to a row."""

    def __init__(self, arena: "KVArena", name: str, pool: VirtualKVPool,
                 plane: Optional[ArenaPlane], n_layers: int, s_max: int):
        self.arena = arena
        self.name = name
        self.pool = pool
        self.plane = plane
        self.n_layers = n_layers
        self.bt_width = max(1, -(-s_max // arena.page_tokens))
        self.row_of: Dict[int, int] = {}       # pool page id -> plane row

    # -------------------------------------------------------------- grants
    def alloc_seq(self, seq_id: int, model: str, tokens: int,
                  alias_rows: Optional[List[int]] = None) -> bool:
        """Grant pages for ``tokens``; the first ``len(alias_rows)`` pages
        map onto those (cached) rows instead of new ones."""
        if not self.pool.alloc_seq(seq_id, model, tokens):
            return False
        self._map(seq_id, alias_rows)
        return True

    def ensure_tokens(self, seq_id: int, total_tokens: int) -> bool:
        """Grow the sequence's page span to cover ``total_tokens``."""
        s = self.pool.seqs[seq_id]
        if total_tokens > s.tokens:
            if not self.pool.extend_seq(seq_id, total_tokens - s.tokens):
                return False
            self._map(seq_id)
        return True

    def _map(self, seq_id: int,
             alias_rows: Optional[List[int]] = None) -> None:
        if self.plane is not None:
            for i, p in enumerate(self.pool.seqs[seq_id].pages):
                if p in self.row_of:
                    continue
                if alias_rows is not None and i < len(alias_rows):
                    # prefix-cache hit: share the existing row (no alloc)
                    self.plane.share_row(alias_rows[i])
                    self.row_of[p] = alias_rows[i]
                    self.arena.pages_aliased += 1
                else:
                    self.row_of[p] = self.plane.take_row()
        self.arena.note_usage()

    def make_private(self, seq_id: int, page_idx: int) -> bool:
        """Copy-on-write: give page ``page_idx`` of the sequence a private
        row if its current row is shared. Returns True when a copy ran."""
        if self.plane is None:
            return False
        pages = self.pool.seqs[seq_id].pages
        if page_idx >= len(pages):
            return False
        p = pages[page_idx]
        row = self.row_of[p]
        if self.plane.refs.get(row, 0) <= 1:
            return False
        new = self.plane.copy_row(row)
        self.plane.drop_row(row)
        self.row_of[p] = new
        self.arena.cow_copies += 1
        return True

    # --------------------------------------------------------------- frees
    def free_seq(self, seq_id: int) -> None:
        """Release a sequence's pages to the pool, then unmap (elastic
        shrink): rows return to the plane exactly when the pool returns the
        bytes to the accountant."""
        self.pool.free_seq(seq_id)
        self.reclaim()

    def reclaim(self) -> None:
        if self.plane is not None:
            for p in self.pool.free_pages:
                row = self.row_of.pop(p, None)
                if row is not None:
                    self.plane.drop_row(row)
        self.pool.reclaim_unmapped()
        self.arena.note_usage()

    def release_all(self) -> None:
        for sid in list(self.pool.seqs):
            self.pool.free_seq(sid)
        self.reclaim()

    # --------------------------------------------------------------- views
    def token_capacity(self, seq_id: int) -> int:
        """Tokens the sequence's CURRENT page grant can hold."""
        return len(self.pool.seqs[seq_id].pages) * self.pool.page_tokens

    def seq_rows(self, seq_id: int) -> List[int]:
        return [self.row_of[p] for p in self.pool.seqs[seq_id].pages]

    def row_table(self, seq_id: int) -> np.ndarray:
        """Block table of one sequence, padded with the null row."""
        out = np.full(self.bt_width, NULL_ROW, np.int32)
        rows = self.seq_rows(seq_id)
        assert len(rows) <= self.bt_width, (len(rows), self.bt_width)
        out[:len(rows)] = rows
        return out

    def write_prompt(self, seq_id: int, k: torch.Tensor,
                     v: torch.Tensor) -> None:
        if self.plane is not None:
            rows = np.asarray(self.seq_rows(seq_id), np.int32)
            self.plane.write_prompt(self.n_layers, rows, k, v)

    # ----------------------------------------------------------- invariant
    def check_mirror(self) -> bool:
        """Every granted page maps to a live non-null row, and nothing else
        is mapped (pages freed to the pool but not yet reclaimed keep
        theirs). Rows may be shared: their reference counts are reconciled
        at the arena level."""
        if self.plane is None:
            return not self.row_of
        pages: set = set()
        for s in self.pool.seqs.values():
            for p in s.pages:
                if self.row_of.get(p, NULL_ROW) == NULL_ROW:
                    return False
                pages.add(p)
        for p in self.pool.free_pages:
            row = self.row_of.get(p)
            if row is not None:
                if row == NULL_ROW:
                    return False
                pages.add(p)
        return set(self.row_of) == pages


class KVArena:
    """Physical paged KV store shared by the engines bound to it."""

    def __init__(self, page_tokens: int = 16, init_rows: int = 8,
                 device=None):
        self.page_tokens = page_tokens
        self.init_rows = init_rows
        self.device = device
        self.planes: Dict[PlaneSpec, ArenaPlane] = {}
        self.bindings: Dict[str, ModelKVBinding] = {}
        self.peak_mapped_pages = 0
        self.peak_mapped_bytes = 0.0
        self.peak_rows = 0
        self.prefix_index: Optional[PrefixIndex] = None
        self.pages_aliased = 0             # pages granted without allocation
        self.cow_copies = 0                # shared rows privatised on write

    def enable_prefix_cache(self, accountant,
                            cfg: Optional[PrefixCacheConfig] = None
                            ) -> PrefixIndex:
        """Attach (idempotently) the node-wide prefix index to this arena."""
        if self.prefix_index is None:
            self.prefix_index = PrefixIndex(self, accountant,
                                            cfg or PrefixCacheConfig())
        return self.prefix_index

    def prefix_digest_summary(self) -> Tuple[str, ...]:
        return self.prefix_index.summary() if self.prefix_index else ()

    def register(self, name: str, pool: VirtualKVPool, s_max: int,
                 n_layers: int, n_kv_heads: int, head_dim: int,
                 dtype: torch.dtype) -> ModelKVBinding:
        """Bind one engine's pool to the arena. ``n_layers == 0`` means the
        model holds no pageable self-attention KV (accounting-only
        binding, no plane)."""
        assert pool.page_tokens == self.page_tokens, \
            (pool.page_tokens, self.page_tokens)
        if name in self.bindings:
            raise ValueError(f"model {name!r} already bound to this arena")
        plane = None
        if n_layers > 0:
            spec = PlaneSpec(n_layers=n_layers, page_tokens=self.page_tokens,
                             n_kv_heads=n_kv_heads, head_dim=head_dim,
                             dtype=dtype)
            plane = self.planes.get(spec)
            if plane is None:
                plane = self.planes[spec] = ArenaPlane(spec, self.init_rows,
                                                       self.device)
        b = ModelKVBinding(self, name, pool, plane, n_layers, s_max)
        self.bindings[name] = b
        return b

    # ------------------------------------------------------------- metrics
    def mapped_pages(self) -> int:
        return sum(b.pool.n_pages for b in self.bindings.values())

    def mapped_bytes(self) -> float:
        return sum(b.pool.n_pages * b.pool.page_bytes
                   for b in self.bindings.values())

    def mapped_rows(self) -> int:
        return sum(len(b.row_of) for b in self.bindings.values())

    def capacity_rows(self) -> int:
        return sum(p.n_rows - 1 for p in self.planes.values())

    def capacity_bytes(self) -> float:
        return sum((p.n_rows - 1) * p.spec.row_bytes
                   for p in self.planes.values())

    def utilization(self) -> float:
        """Peak mapped rows over allocated plane capacity."""
        cap = self.capacity_rows()
        return self.peak_rows / cap if cap else 0.0

    def note_usage(self) -> None:
        self.peak_mapped_pages = max(self.peak_mapped_pages,
                                     self.mapped_pages())
        self.peak_mapped_bytes = max(self.peak_mapped_bytes,
                                     self.mapped_bytes())
        self.peak_rows = max(self.peak_rows, self.mapped_rows())

    def stats(self) -> Dict[str, float]:
        return {
            "planes": len(self.planes),
            "page_tokens": self.page_tokens,
            "mapped_pages": self.mapped_pages(),
            "mapped_rows": self.mapped_rows(),
            "capacity_rows": self.capacity_rows(),
            "capacity_bytes": self.capacity_bytes(),
            "peak_mapped_pages": self.peak_mapped_pages,
            "peak_mapped_bytes": self.peak_mapped_bytes,
            "utilization": round(self.utilization(), 4),
            "pages_aliased": self.pages_aliased,
            "cow_copies": self.cow_copies,
        }

    def check_mirror(self) -> bool:
        if not all(b.check_mirror() for b in self.bindings.values()):
            return False
        # plane level: the refcount of every live row equals its binding
        # mappings plus prefix-index pins, and live + free rows exactly tile
        # each plane (minus the null row)
        for plane in self.planes.values():
            expect: Counter = Counter()
            for b in self.bindings.values():
                if b.plane is plane:
                    expect.update(b.row_of.values())
            if self.prefix_index is not None:
                expect.update(self.prefix_index.row_pins(plane))
            if NULL_ROW in expect or dict(plane.refs) != dict(expect):
                return False
            if set(plane.free_rows) & set(plane.refs):
                return False
            if len(plane.free_rows) + len(plane.refs) != plane.n_rows - 1:
                return False
        return True
