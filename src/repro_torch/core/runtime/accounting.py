"""Explicit GPU memory accounting with admission-time feasibility checks
(§III.C): M_kv + M_res <= M_total, where M_res = sum(M_ctx^k) + M_other.

The accountant is the single source of truth the node runtime, the KV pool
and the scheduler all read; the KV admission headroom R_kv_head(N) it exports
is the routing signal of Eq. 5's affinity term.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


class AdmissionError(Exception):
    pass


@dataclasses.dataclass
class MemoryAccountant:
    m_total: float                       # total device memory for the runtime
    m_other: float = 0.0                 # non-model overheads
    m_kv: float = 0.0                    # current KV usage
    ctx: Dict[str, float] = dataclasses.field(default_factory=dict)
    weights: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def m_res(self) -> float:
        """Reserved non-KV footprint: warm contexts + resident weights + other."""
        return sum(self.ctx.values()) + sum(self.weights.values()) + self.m_other

    @property
    def headroom(self) -> float:
        """R_kv_head(N) = M_total - M_res - M_kv."""
        return self.m_total - self.m_res - self.m_kv

    def check_invariant(self) -> bool:
        return self.m_kv + self.m_res <= self.m_total + 1e-6

    # ------------------------------------------------------------ mutation
    def register_context(self, model: str, nbytes: float) -> None:
        self.ctx[model] = nbytes

    def unregister_context(self, model: str) -> None:
        self.ctx.pop(model, None)

    def register_weights(self, model: str, nbytes: float) -> None:
        self.weights[model] = nbytes

    def unregister_weights(self, model: str) -> None:
        self.weights.pop(model, None)

    def can_admit(self, r_need: float) -> bool:
        return r_need <= self.headroom

    def admit_kv(self, r_need: float) -> None:
        if not self.can_admit(r_need):
            raise AdmissionError(
                f"KV admission of {r_need/1e9:.2f}GB exceeds headroom "
                f"{self.headroom/1e9:.2f}GB")
        self.m_kv += r_need

    def release_kv(self, nbytes: float) -> None:
        self.m_kv = max(0.0, self.m_kv - nbytes)
