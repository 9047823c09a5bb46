"""Cross-stage prefix-cache plane: content-hashed KV pages with refcounts.

The port's own copy of ``repro/serving/prefix_cache.py`` (pure Python and
``hashlib``; no tensors). Digests are bit-identical to the reference's, so
a gateway routing by digest sees the same strings from either package.

Multi-agent workflows re-send shared context on every stage — the team
system prompt, the per-role template, the carried conversation.  This
module gives each node a *prefix index*: a content-addressed map from
chained page digests to physical ``ArenaPlane`` rows.  On a hit the
engine aliases the existing rows (no allocation, no prefill compute for
those tokens) and copy-on-writes the first divergent page, so eviction
and sleep accounting stay exact.

Digests are chained: the digest of page ``i`` commits to the digests of
all pages before it, so a single digest identifies the whole prefix up
to and including that page.  Hashing is keyed by model name — two
models never share an entry even when their planes coincide.

The index pins rows via plane refcounts so prefixes survive the release
of the sequence that created them (vLLM-style).  Pinned bytes are
charged to the node accountant under the ``"prefix-cache"`` context key
and fully recovered by ``flush_model`` / ``flush`` (engine sleep) or
LRU eviction under memory pressure. The index holds plane objects, not
their tensors, so a plane that grows (new tensors) needs no update here.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

_DIGEST_BYTES = 12


@dataclass(frozen=True)
class PrefixCacheConfig:
    enabled: bool = True
    max_pages: int = 256          # cap on index entries (pinned rows)
    summary_digests: int = 64     # digests advertised in NodeSignal


def root_key(namespace: str) -> str:
    """Chain seed for a namespace (model name)."""
    return f"pfx::{namespace}"


def _chain(parent: str, tokens: Sequence[int]) -> str:
    h = hashlib.blake2b(digest_size=_DIGEST_BYTES)
    h.update(parent.encode())
    h.update(b"|")
    h.update(",".join(str(int(t)) for t in tokens).encode())
    return h.hexdigest()


def page_digests(tokens: Sequence[int], page_tokens: int,
                 namespace: str) -> List[str]:
    """Chained digests for every *full* page of ``tokens``."""
    out: List[str] = []
    parent = root_key(namespace)
    for i in range(len(tokens) // page_tokens):
        parent = _chain(parent, tokens[i * page_tokens:(i + 1) * page_tokens])
        out.append(parent)
    return out


@dataclass
class PrefixEntry:
    digest: str
    model: str
    plane: object                 # ArenaPlane (duck-typed; no import cycle)
    row: int
    tokens: Tuple[int, ...]       # the tokens stored in this page
    parent: str                   # parent digest or root key
    n_prefix_tokens: int          # tokens covered through this page
    lru: int = 0


@dataclass
class PrefixMatch:
    rows: List[int] = field(default_factory=list)   # full-page alias rows
    n_full_tokens: int = 0
    partial_row: Optional[int] = None               # row to alias + COW
    partial_overlap: int = 0                        # leading tokens shared
    digests: List[str] = field(default_factory=list)

    @property
    def tokens_matched(self) -> int:
        return self.n_full_tokens + self.partial_overlap


class PrefixIndex:
    """Per-node refcounted content index over arena rows."""

    def __init__(self, arena, accountant, cfg: PrefixCacheConfig):
        self.arena = arena
        self.acc = accountant
        self.cfg = cfg
        self.entries: Dict[str, PrefixEntry] = {}
        self.children: Dict[str, Set[str]] = {}
        self._clock = 0
        # counters (surface via stats())
        self.lookups = 0
        self.hits = 0
        self.partial_hits = 0
        self.tokens_avoided = 0
        self.inserts = 0
        self.evictions = 0
        self.cow_copies = 0

    # ---------------------------------------------------------------- match
    def match(self, model: str, digests: Sequence[str],
              tokens: Sequence[int], page_tokens: int) -> PrefixMatch:
        """Walk the digest chain; then probe a partial tail page."""
        self.lookups += 1
        m = PrefixMatch()
        parent = root_key(model)
        for d in digests:
            e = self.entries.get(d)
            if e is None or e.parent != parent:
                break
            self._touch(e)
            m.rows.append(e.row)
            m.n_full_tokens = e.n_prefix_tokens
            parent = d
        # partial tail: longest leading-token overlap among children of the
        # last matched digest against the prompt's next page.
        tail = tokens[m.n_full_tokens:m.n_full_tokens + page_tokens]
        best, best_ov = None, 0
        for cd in self.children.get(parent, ()):
            e = self.entries.get(cd)
            if e is None:
                continue
            ov = 0
            for a, b in zip(e.tokens, tail):
                if a != b:
                    break
                ov += 1
            if ov > best_ov:
                best, best_ov = e, ov
        if best is not None and best_ov > 0:
            self._touch(best)
            m.partial_row = best.row
            m.partial_overlap = best_ov
        if m.rows or m.partial_row is not None:
            self.hits += 1
            if m.partial_row is not None:
                self.partial_hits += 1
        return m

    # --------------------------------------------------------------- insert
    def insert(self, model: str, digest: str, parent: str, plane, row: int,
               tokens: Sequence[int], n_prefix_tokens: int) -> bool:
        if digest in self.entries:
            self._touch(self.entries[digest])
            return False
        # polite: make room under both the entry cap and the accountant.
        while self.entries and (len(self.entries) >= self.cfg.max_pages
                                or self.acc.headroom < plane.spec.row_bytes):
            self._evict_lru()
        if len(self.entries) >= self.cfg.max_pages or \
                self.acc.headroom < plane.spec.row_bytes:
            return False
        plane.share_row(row)
        e = PrefixEntry(digest=digest, model=model, plane=plane, row=row,
                        tokens=tuple(int(t) for t in tokens), parent=parent,
                        n_prefix_tokens=n_prefix_tokens)
        self._touch(e)
        self.entries[digest] = e
        self.children.setdefault(parent, set()).add(digest)
        self.inserts += 1
        self._recharge()
        return True

    # ------------------------------------------------------------- eviction
    def _touch(self, e: PrefixEntry) -> None:
        self._clock += 1
        e.lru = self._clock

    def _remove(self, digest: str) -> None:
        e = self.entries.pop(digest)
        kids = self.children.get(e.parent)
        if kids:
            kids.discard(digest)
            if not kids:
                del self.children[e.parent]
        e.plane.drop_row(e.row)
        self._recharge()

    def _evict_lru(self) -> None:
        # evict leaves first so chains stay walkable from the root
        leaves = [d for d in self.entries if d not in self.children]
        pool = leaves or list(self.entries)
        victim = min(pool, key=lambda d: self.entries[d].lru)
        self._remove(victim)
        self.evictions += 1

    def trim(self, n: int) -> int:
        """Evict up to ``n`` entries (memory-pressure hook)."""
        done = 0
        while self.entries and done < n:
            self._evict_lru()
            done += 1
        return done

    def flush_model(self, model: str) -> None:
        for d in [d for d, e in self.entries.items() if e.model == model]:
            self._remove(d)

    def flush(self) -> None:
        for d in list(self.entries):
            self._remove(d)

    # ------------------------------------------------------------ accounting
    def pinned_bytes(self) -> int:
        return sum(e.plane.spec.row_bytes for e in self.entries.values())

    def _recharge(self) -> None:
        b = self.pinned_bytes()
        if b:
            self.acc.register_context("prefix-cache", b)
        else:
            self.acc.unregister_context("prefix-cache")

    def row_pins(self, plane) -> Dict[int, int]:
        pins: Dict[int, int] = {}
        for e in self.entries.values():
            if e.plane is plane:
                pins[e.row] = pins.get(e.row, 0) + 1
        return pins

    # -------------------------------------------------------------- surface
    def summary(self) -> Tuple[str, ...]:
        """Most-recently-used digests, for the NodeSignal snapshot."""
        order = sorted(self.entries.values(), key=lambda e: -e.lru)
        return tuple(e.digest for e in order[:self.cfg.summary_digests])

    def stats(self) -> Dict[str, float]:
        return {
            "prefix_entries": len(self.entries),
            "prefix_pinned_bytes": float(self.pinned_bytes()),
            "prefix_lookups": self.lookups,
            "prefix_hits": self.hits,
            "prefix_partial_hits": self.partial_hits,
            "prefix_tokens_avoided": self.tokens_avoided,
            "prefix_inserts": self.inserts,
            "prefix_evictions": self.evictions,
            "prefix_cow_copies": self.cow_copies,
            "prefix_pages_aliased": getattr(self.arena, "pages_aliased", 0),
        }
