"""Elastic virtual KV cache pool — the allocator-level analogue of CUDA-VMM
kvcached (§III.C "spatial multiplexing"); the port's copy of
``repro/core/runtime/kv_pool.py``.

Elasticity is implemented at the allocator, not by virtual-memory remaps:
a shared arena of fixed-size KV pages; each colocated model
advertises a VIRTUAL budget (sum of virtual budgets may exceed physical — the
paper's 3.05x overcommit of Table V), while PHYSICAL pages are granted on
demand under the accountant's admission check. Allocation failure is a signal
(reject / degrade), never an OOM.

The pure-python pool here is the accounting + page-table layer. The
array-backed store that physically holds K/V is
:class:`repro_torch.serving.kv_arena.KVArena`: a
:class:`~repro_torch.serving.kv_arena.ModelKVBinding` mirrors every page grant of
this pool 1:1 onto an arena plane row (mapped on ``alloc_seq``/
``extend_seq``, returned on ``free_seq`` + ``reclaim_unmapped``), so
admission decisions made against this pool govern real memory.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core.runtime.accounting import MemoryAccountant


@dataclasses.dataclass
class SeqAlloc:
    seq_id: int
    model: str
    pages: List[int]
    tokens: int = 0


class VirtualKVPool:
    def __init__(self, accountant: MemoryAccountant, page_bytes: int,
                 page_tokens: int):
        self.acc = accountant
        self.page_bytes = page_bytes
        self.page_tokens = page_tokens
        self.free_pages: List[int] = []
        self.n_pages = 0          # currently-mapped physical pages
        self._next_id = 0         # monotonic page-id source
        self.seqs: Dict[int, SeqAlloc] = {}
        self.virtual_budget: Dict[str, float] = {}

    # -------------------------------------------------------------- budget
    def set_virtual_budget(self, model: str, nbytes: float) -> None:
        self.virtual_budget[model] = nbytes

    def virtual_total(self) -> float:
        return sum(self.virtual_budget.values())

    def overcommit_ratio(self) -> float:
        """(virtual KV + reserved) / physical — Table V's 3.05x metric."""
        return ((self.virtual_total() + self.acc.m_res) /
                max(self.acc.m_total, 1e-9))

    def model_virtual_used(self, model: str) -> float:
        return sum(len(s.pages) for s in self.seqs.values()
                   if s.model == model) * self.page_bytes

    # ------------------------------------------------------------- physical
    def _grow(self, n: int) -> bool:
        """Map n new physical pages (admission-checked)."""
        need = n * self.page_bytes
        if not self.acc.can_admit(need):
            return False
        self.acc.admit_kv(need)
        self.free_pages.extend(range(self._next_id, self._next_id + n))
        self._next_id += n
        self.n_pages += n
        return True

    def alloc_seq(self, seq_id: int, model: str, tokens: int) -> bool:
        """Admit a sequence needing `tokens` of KV; grants pages on demand."""
        n = max(1, -(-tokens // self.page_tokens))
        if (self.model_virtual_used(model) + n * self.page_bytes
                > self.virtual_budget.get(model, float("inf"))):
            return False
        if len(self.free_pages) < n and not self._grow(n - len(self.free_pages)):
            return False
        pages = [self.free_pages.pop() for _ in range(n)]
        self.seqs[seq_id] = SeqAlloc(seq_id, model, pages, tokens)
        return True

    def extend_seq(self, seq_id: int, new_tokens: int) -> bool:
        """Grow a sequence's KV as it decodes (on-demand page mapping)."""
        s = self.seqs[seq_id]
        total = s.tokens + new_tokens
        need = max(0, -(-total // self.page_tokens) - len(s.pages))
        if need:
            if len(self.free_pages) < need and \
                    not self._grow(need - len(self.free_pages)):
                return False
            s.pages.extend(self.free_pages.pop() for _ in range(need))
        s.tokens = total
        return True

    def free_seq(self, seq_id: int) -> None:
        s = self.seqs.pop(seq_id, None)
        if s is None:
            return
        self.free_pages.extend(s.pages)

    def reclaim_unmapped(self) -> float:
        """Unmap free pages back to the accountant (elastic shrink)."""
        freed = len(self.free_pages) * self.page_bytes
        # compact: renumber is unnecessary for accounting purposes
        self.acc.release_kv(freed)
        self.n_pages -= len(self.free_pages)
        self.free_pages.clear()
        return freed

    # ------------------------------------------------------------- metrics
    def physical_used(self) -> float:
        return (self.n_pages - len(self.free_pages)) * self.page_bytes

    def fragmentation(self) -> float:
        """Internal fragmentation: allocated-but-unused token slots."""
        alloc_tokens = sum(len(s.pages) for s in self.seqs.values()) \
            * self.page_tokens
        used_tokens = sum(s.tokens for s in self.seqs.values())
        return 1.0 - used_tokens / alloc_tokens if alloc_tokens else 0.0
