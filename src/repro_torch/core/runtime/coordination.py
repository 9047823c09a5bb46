"""Minimum-impact memory coordination (§III.C, Algorithm 2 + Eq. 4); the
port's copy of ``repro/core/runtime/coordination.py``.

When KV admission fails, derive a degradation plan by walking resident
engines in ascending disruption order and accumulating freed memory.
Five degradation levels:
  1. Idle-RUNNING  -> SLEEPING   (offload weights, keep context)
  2. evict SLEEPING              (drop warm context + host copy stays)
  3. stop pending sleep transitions
  4. swap out KV of ACTIVE engines
  5. abort ACTIVE executions

The plan's total disruption penalty (Eq. 4):
  C_deg = sum c(e, a) + 1[I_active] * c_int
with c(e,a) from profiled storage bandwidth (weight reload) or compute
throughput (KV regeneration), and c_int the SLO-violation charge.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple

from repro_torch.core.predictor.cost_model import HardwareSpec
from repro_torch.core.runtime.residency import RETRACE_COST_S


class EngineState(enum.Enum):
    IDLE = "idle"            # RUNNING but no in-flight request
    SLEEPING = "sleeping"
    PENDING_SLEEP = "pending_sleep"
    ACTIVE = "active"


class Action(enum.Enum):
    SLEEP = "sleep"                  # level 1
    EVICT_SLEEPING = "evict"         # level 2
    CANCEL_SLEEP = "cancel_sleep"    # level 3
    SWAP_KV = "swap_kv"              # level 4
    ABORT = "abort"                  # level 5


_PRIORITY = {EngineState.IDLE: 0, EngineState.SLEEPING: 1,
             EngineState.PENDING_SLEEP: 2, EngineState.ACTIVE: 3}


@dataclasses.dataclass
class EngineInfo:
    model: str
    state: EngineState
    weight_bytes: float
    ctx_bytes: float
    kv_bytes: float = 0.0
    kv_tokens: int = 0
    decode_tok_per_s: float = 50.0       # for KV regeneration cost


@dataclasses.dataclass
class DegradationPlan:
    steps: List[Tuple[EngineInfo, Action]]
    freed: float
    interrupts_active: bool
    c_deg: float

    @property
    def feasible(self) -> bool:
        return bool(self.steps) or self.freed > 0


def _best_action(e: EngineInfo) -> Tuple[Optional[Action], float]:
    """(action, freed bytes) for an engine by its state (level ordering)."""
    if e.state is EngineState.IDLE:
        return Action.SLEEP, e.weight_bytes
    if e.state is EngineState.SLEEPING:
        return Action.EVICT_SLEEPING, e.ctx_bytes
    if e.state is EngineState.PENDING_SLEEP:
        return Action.CANCEL_SLEEP, e.weight_bytes
    if e.state is EngineState.ACTIVE:
        if e.kv_bytes > 0:
            return Action.SWAP_KV, e.kv_bytes
        return Action.ABORT, e.weight_bytes + e.kv_bytes
    return None, 0.0


def action_cost(e: EngineInfo, a: Action, hw: HardwareSpec) -> float:
    """c(e, a): restoration latency of undoing the degradation."""
    if a is Action.SLEEP or a is Action.CANCEL_SLEEP:
        return e.weight_bytes / hw.host_link_bw
    if a is Action.EVICT_SLEEPING:
        # the context goes cold + weights re-staged later
        return e.weight_bytes / hw.host_link_bw + RETRACE_COST_S
    if a is Action.SWAP_KV:
        # KV regeneration: recompute kv_tokens at decode throughput
        return e.kv_tokens / max(e.decode_tok_per_s, 1e-9)
    if a is Action.ABORT:
        return e.kv_tokens / max(e.decode_tok_per_s, 1e-9) + RETRACE_COST_S
    return 0.0


def plan_degradation(required: float, engines: List[EngineInfo],
                     hw: HardwareSpec, c_int: float = 5.0
                     ) -> Optional[DegradationPlan]:
    """Algorithm 2. Returns None when even full degradation cannot free
    ``required`` bytes (the scheduler then reports infeasibility)."""
    freed = 0.0
    steps: List[Tuple[EngineInfo, Action]] = []
    interrupts = False
    c_deg = 0.0
    for e in sorted(engines, key=lambda e: _PRIORITY[e.state]):
        if freed >= required:
            break
        a, f = _best_action(e)
        if a is None or f <= 0:
            continue
        if a in (Action.SWAP_KV, Action.ABORT):
            interrupts = True
        freed += f
        c_deg += action_cost(e, a, hw)
        steps.append((e, a))
    if freed < required:
        return None
    if interrupts:
        c_deg += c_int
    return DegradationPlan(steps, freed, interrupts, c_deg)
