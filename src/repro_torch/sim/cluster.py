"""Simulated node/cluster state: each node owns a hierarchical residency
manager, a memory accountant and an elastic KV pool — the same core objects
the real serving runtime uses, driven by simulated time."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.predictor.cost_model import HardwareSpec, ModelProfile
from repro_torch.core.runtime.accounting import MemoryAccountant
from repro_torch.core.runtime.coordination import (EngineInfo, EngineState,
                                                   plan_degradation)
from repro_torch.core.runtime.residency import (HierarchicalResidency,
                                                ModelState)
from repro_torch.core.sched.fitness import NodeSignal


@dataclasses.dataclass
class RunningStage:
    stage_id: int
    model: str
    kv_reserved: float
    finish_at: float


class SimNode:
    def __init__(self, node_id: int, cluster_id: int,
                 profiles: Dict[str, ModelProfile],
                 hbm: float = 40e9, max_concurrency: int = 8,
                 hw: Optional[HardwareSpec] = None,
                 host_ram: float = 256e9, disk: float = 2e12):
        self.node_id = node_id
        self.cluster_id = cluster_id
        self.profiles = profiles
        self.hw = hw or HardwareSpec()
        self.residency = HierarchicalResidency(
            profiles, c_gpu=hbm * 0.9, c_cpu=host_ram, c_disk=disk, hw=self.hw)
        self.acc = MemoryAccountant(m_total=hbm, m_other=1e9)
        self.max_concurrency = max_concurrency
        self.running: Dict[int, RunningStage] = {}
        self.queue_delay_ewma = 0.0
        self.busy_until = 0.0

    # ----------------------------------------------------------- signals
    def signal(self) -> NodeSignal:
        warm = {}
        for m in self.residency.warm_set():
            warm[m] = self.residency.activation_latency(m)
        return NodeSignal(node_id=self.node_id, cluster_id=self.cluster_id,
                          headroom=self.acc.headroom,
                          queue_delay_s=self.queue_delay_ewma,
                          warm_models=warm, total_hbm=self.acc.m_total)

    def t_act(self, model: str) -> float:
        return self.residency.activation_latency(model)

    def has_slot(self) -> bool:
        return len(self.running) < self.max_concurrency

    def activation_delta(self, model: str) -> float:
        """Extra M_res bytes that activating `model` would add."""
        prof = self.profiles[model]
        st = self.residency.state[model]
        delta = 0.0
        if model not in self.acc.weights:
            delta += prof.weight_bytes
        if model not in self.acc.ctx:
            delta += prof.ctx_bytes
        return delta

    def can_admit(self, r_need: float, model: Optional[str] = None) -> bool:
        if not self.has_slot():
            return False
        extra = self.activation_delta(model) if model else 0.0
        if self.acc.can_admit(r_need + extra):
            return True
        if model is None:
            return False
        # eviction-aware feasibility (degradation levels 1-2 are available to
        # the activation path): everything except in-flight models' weights
        # and contexts can be reclaimed
        active = {r.model for r in self.running.values()} | {model}
        floor = sum(self.profiles[m].weight_bytes + self.profiles[m].ctx_bytes
                    for m in active)
        return (floor + self.acc.m_kv + self.acc.m_other + r_need
                <= self.acc.m_total)

    def degradation_cost(self, r_need: float) -> Optional[float]:
        """C_deg for admitting r_need via Algorithm 2 (None = impossible)."""
        shortfall = r_need - self.acc.headroom
        if shortfall <= 0:
            return 0.0
        engines = []
        for m in self.residency.warm_set():
            st = self.residency.state[m]
            active = any(r.model == m for r in self.running.values())
            kv = sum(r.kv_reserved for r in self.running.values()
                     if r.model == m)
            engines.append(EngineInfo(
                model=m,
                state=(EngineState.ACTIVE if active else
                       EngineState.IDLE if st is ModelState.RUNNING
                       else EngineState.SLEEPING),
                weight_bytes=self.profiles[m].weight_bytes,
                ctx_bytes=self.profiles[m].ctx_bytes,
                kv_bytes=kv,
                kv_tokens=int(kv / max(
                    self.profiles[m].alpha_bytes_per_token, 1)),
                decode_tok_per_s=1.0 / self.profiles[m].t_decode))
        plan = plan_degradation(shortfall, engines, self.hw)
        return None if plan is None else plan.c_deg

    # ----------------------------------------------------------- execution
    def activate(self, model: str) -> float:
        """Ensure weights on device; returns activation seconds. Updates the
        accountant's weight/context registry to mirror residency state."""
        self.residency.pinned = {r.model for r in self.running.values()}
        ok, t_act = self.residency.ensure_gpu(model)
        if not ok:
            return float("inf")
        self._sync_accounting()
        return t_act

    def make_room(self, r_need: float) -> None:
        """Degradation levels 1-2: sleep idle models, then drop sleeping
        contexts, until r_need fits (Algorithm 2's cheap prefix)."""
        active = {r.model for r in self.running.values()}
        for m in list(self.residency.lru["gpu"]):
            if self.acc.can_admit(r_need):
                return
            if m not in active:
                self.residency.sleep(m)               # level 1
                self._sync_accounting()
        for m, st in list(self.residency.state.items()):
            if self.acc.can_admit(r_need):
                return
            if m not in active and st is ModelState.SLEEPING:
                self.residency.demote_context(m)      # level 2
                self._sync_accounting()

    def _sync_accounting(self) -> None:
        self.acc.weights.clear()
        self.acc.ctx.clear()
        for m, st in self.residency.state.items():
            if st is ModelState.RUNNING:
                self.acc.register_weights(m, self.profiles[m].weight_bytes)
                self.acc.register_context(m, self.profiles[m].ctx_bytes)
            elif st is ModelState.SLEEPING:
                self.acc.register_context(m, self.profiles[m].ctx_bytes)

    def start(self, stage_id: int, model: str, kv: float, finish_at: float,
              now: float, enqueue_t: float) -> None:
        self.acc.admit_kv(kv)
        self.running[stage_id] = RunningStage(stage_id, model, kv, finish_at)
        wait = max(0.0, now - enqueue_t)
        self.queue_delay_ewma = 0.8 * self.queue_delay_ewma + 0.2 * wait

    def finish(self, stage_id: int) -> None:
        r = self.running.pop(stage_id, None)
        if r is not None:
            self.acc.release_kv(r.kv_reserved)
