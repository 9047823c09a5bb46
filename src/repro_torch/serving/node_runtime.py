"""Node-level multi-model runtime: real model co-location on one card; the
port of ``repro/serving/node_runtime.py``.

Holds a zoo of models whose weights move between the card and host memory
following the hierarchical residency manager. The host tier is a dict of
CPU tensors per model, pinned when the node runs on CUDA. Offload drops a
model's parameters from the card; activation copies the host tier back
into the same parameters (``non_blocking``) and synchronises before it
reads its clock, so the seconds it returns hold the transfer. Each
:class:`~repro_torch.models.transformer.Model` owns its weights and its
engine keeps it across sleep: a Sleeping model keeps its engine object
(the warm context) while its weights live in host memory. Exports the
readiness / headroom signals (:class:`NodeSignal`) the cross-cluster
scheduler consumes.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import dtype_bytes
from repro_torch.core.predictor.cost_model import HardwareSpec, ModelProfile
from repro_torch.core.runtime.accounting import MemoryAccountant
from repro_torch.core.runtime.coordination import (EngineInfo, EngineState,
                                                   plan_degradation)
from repro_torch.core.runtime.residency import (HierarchicalResidency,
                                                ModelState)
from repro_torch.core.sched.fitness import NodeSignal
from repro_torch.models.transformer import Model
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.kv_arena import KVArena
from repro_torch.serving.prefix_cache import PrefixCacheConfig

Weights = Dict[str, torch.Tensor]       # parameter name -> tensor


def _tree_bytes(weights: Weights) -> int:
    return sum(t.nbytes for t in weights.values())


class NodeRuntime:
    def __init__(self, node_id: int, cluster_id: int,
                 zoo: Dict[str, Model], host_params: Dict[str, dict],
                 hbm_budget: float = 2e9, max_slots: int = 4,
                 s_max: int = 256, ctx_bytes: int = 8 << 20,
                 page_tokens: int = 16, prefix_cache: bool = False,
                 prefix_cache_pages: int = 256,
                 max_batch_tokens: Optional[int] = None,
                 prefill_chunk_tokens: int = 0,
                 decode_horizon: int = 1, device=None):
        """``zoo``: the models this node serves, each owned by this node
        alone (no two nodes share a Model): their weights leave the card
        here, as every model starts in host memory. ``host_params``: each
        model's parameter tree in the port's layout (``init_params`` /
        ``params_from_jax``), on any device; the node keeps a host copy of
        it (pinned on CUDA; CPU tensors already pinned, or any CPU tensor
        on a CPU node, are kept as they are). ``device``: ``cuda`` unless
        the caller names another. The residency and degradation models
        assume one H100 (:class:`HardwareSpec`)."""
        self.node_id = node_id
        self.cluster_id = cluster_id
        self.device = resolve_device(device)
        self.zoo = zoo
        self.host_params: Dict[str, Weights] = {
            name: self._host_tier(m, host_params[name])
            for name, m in zoo.items()}
        self.device_params: Dict[str, Weights] = {}
        for m in zoo.values():
            self._drop_weights(m)
        self.engines: Dict[str, Engine] = {}
        self.acc = MemoryAccountant(m_total=hbm_budget, m_other=16 << 20)
        # ONE physical paged-KV arena per node: every colocated engine's
        # pool grants map onto it 1:1 (§III.C spatial multiplexing)
        self.arena = KVArena(page_tokens=page_tokens, device=self.device)
        self.prefix_cfg = (PrefixCacheConfig(max_pages=prefix_cache_pages)
                           if prefix_cache else None)
        self.ctx_bytes = ctx_bytes
        self.max_slots = max_slots
        self.s_max = s_max
        # engine iteration-scheduler knobs, forwarded to every colocated
        # engine at activation
        self.max_batch_tokens = max_batch_tokens
        self.prefill_chunk_tokens = prefill_chunk_tokens
        self.decode_horizon = decode_horizon
        self.profiles = {
            name: ModelProfile(
                name=name, weight_bytes=_tree_bytes(self.host_params[name]),
                ctx_bytes=ctx_bytes,
                # dtype-aware: must match the engine pool's per-token charge
                alpha_bytes_per_token=m.cfg.kv_bytes_per_token(
                    dtype_bytes=dtype_bytes(m.cfg.dtype)),
                state_bytes=m.cfg.ssm_state_bytes(),
                prefill_flops_per_token=2.0 * m.cfg.active_param_count(),
                decode_bytes_per_token=2.0 * m.cfg.active_param_count(),
                hw=HardwareSpec())
            for name, m in zoo.items()}
        self.residency = HierarchicalResidency(
            self.profiles, c_gpu=hbm_budget * 0.8, c_cpu=64e9, c_disk=1e12)
        # host tier is where everything starts
        for name in zoo:
            self.residency.state[name] = ModelState.CPU
            self.residency.lru["cpu"][name] = self.profiles[name].weight_bytes

    # -------------------------------------------------------------- weights
    def _host_tier(self, model: Model, tree: dict) -> Weights:
        """The model's weights in host memory, by parameter name."""
        pin = self.device.type == "cuda"
        out = {}
        # a Model over the tree names its leaves as the served one does
        for n, p in Model(model.cfg, tree).named_parameters():
            t = p.data
            if t.device.type != "cpu" or (pin and not t.is_pinned()):
                t = torch.empty(t.shape, dtype=t.dtype, device="cpu",
                                pin_memory=pin).copy_(t)
            out[n] = t
        return out

    def _drop_weights(self, model: Model) -> None:
        """Release the model's device copy: each parameter keeps its name
        and dtype over an empty tensor on the node's device."""
        for p in model.parameters():
            p.data = torch.empty(0, dtype=p.dtype, device=self.device)

    def _load_weights(self, name: str) -> Weights:
        """Host -> device copies into the model's own parameters, then a
        synchronise: the caller's clock then holds the transfer."""
        host = self.host_params[name]
        dev = {}
        for n, p in self.zoo[name].named_parameters():
            src = host[n]
            dev[n] = torch.empty(src.shape, dtype=src.dtype,
                                 device=self.device).copy_(
                src, non_blocking=True)
            p.data = dev[n]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return dev

    # ------------------------------------------------------------ residency
    def activate(self, name: str) -> float:
        """Make `name` servable; returns measured activation seconds."""
        t0 = time.perf_counter()
        # models with ANY queued work are in-flight: evicting one whose
        # requests are still waiting for admission would strand them (step()
        # skips off-device engines)
        self.residency.pinned = {m for m, e in self.engines.items()
                                 if e.active or e.waiting}
        ok, _ = self.residency.ensure_gpu(name)
        if not ok:
            raise RuntimeError(f"cannot activate {name}")
        # apply evictions the residency manager decided
        for m, st in self.residency.state.items():
            if st in (ModelState.SLEEPING, ModelState.CPU) \
                    and m in self.device_params:
                self._offload(m)
        if name not in self.device_params:
            self.device_params[name] = self._load_weights(name)
            self.acc.register_weights(
                name, self.profiles[name].weight_bytes)
            self.acc.register_context(name, self.ctx_bytes)
        if name not in self.engines:
            self.engines[name] = Engine(
                self.zoo[name], self.acc,
                max_slots=self.max_slots, s_max=self.s_max,
                arena=self.arena, prefix_cache=self.prefix_cfg,
                prefix_ns=name,
                max_batch_tokens=self.max_batch_tokens,
                prefill_chunk_tokens=self.prefill_chunk_tokens,
                decode_horizon=self.decode_horizon, device=self.device)
        return time.perf_counter() - t0

    def _offload(self, name: str) -> None:
        """Device -> host: the weights leave the card (the host tier already
        holds them) and the engine object stays. The engine's KV — arena
        pages, prefix pins, block tables and the dense state cache — is
        freed and de-accounted here: an offloaded model holds no silent
        device-resident KV."""
        eng = self.engines.get(name)
        if eng is not None:
            eng.release_kv()
        self.device_params.pop(name, None)
        self._drop_weights(self.zoo[name])
        self.acc.unregister_weights(name)
        if self.residency.state[name] is ModelState.CPU:
            self.acc.unregister_context(name)

    def sleep(self, name: str) -> None:
        self.residency.sleep(name)
        self._offload(name)

    # -------------------------------------------------------------- serving
    def submit(self, model: str, req: Request) -> None:
        if model not in self.device_params:
            self.activate(model)
        self.engines[model].submit(req)

    def preempt(self, model: str, req_id: int) -> Optional[Request]:
        """Boundary-preempt a request on this node (waiting or active);
        returns the withdrawn Request (partial output discarded) or None."""
        eng = self.engines.get(model)
        return None if eng is None else eng.evict(req_id)

    def t_act(self, model: str) -> float:
        """Estimated activation latency (no side effects) — the T_act of
        Eq. 6 that the cross-cluster router consumes."""
        return self.residency.activation_latency(model)

    # ----------------------------------------------- admission (Alg. 2 aware)
    def _busy_models(self) -> set:
        return {m for m, e in self.engines.items() if e.active or e.waiting}

    def can_admit(self, r_need: float, model: Optional[str] = None) -> bool:
        """Eviction-aware KV admission feasibility: everything except
        in-flight models' weights and contexts can be reclaimed by
        degradation levels 1-2 before the stage lands."""
        extra = 0.0
        if model is not None:
            if model not in self.acc.weights:
                extra += self.profiles[model].weight_bytes
            if model not in self.acc.ctx:
                extra += self.profiles[model].ctx_bytes
        if self.acc.can_admit(r_need + extra):
            return True
        if model is None:
            return False
        active = self._busy_models() | {model}
        floor = sum(self.profiles[m].weight_bytes + self.profiles[m].ctx_bytes
                    for m in active)
        # in-flight engines also keep their dense state caches resident
        floor += sum(e._state_bytes for m2, e in self.engines.items()
                     if m2 in active)
        return (floor + self.acc.m_kv + self.acc.m_other + r_need
                <= self.acc.m_total)

    def degradation_cost(self, r_need: float) -> Optional[float]:
        """C_deg for admitting r_need via Algorithm 2 (None = impossible),
        built from the real engines' in-flight state."""
        shortfall = r_need - self.acc.headroom
        if shortfall <= 0:
            return 0.0
        busy = self._busy_models()
        engines = []
        for m in self.residency.warm_set():
            st = self.residency.state[m]
            eng = self.engines.get(m)
            kv_tokens = (sum(len(r.tokens) + len(r.out)
                             for r in eng.active.values()) if eng else 0)
            prof = self.profiles[m]
            engines.append(EngineInfo(
                model=m,
                state=(EngineState.ACTIVE if m in busy else
                       EngineState.IDLE if st is ModelState.RUNNING
                       else EngineState.SLEEPING),
                weight_bytes=prof.weight_bytes,
                ctx_bytes=prof.ctx_bytes,
                kv_bytes=float((eng.alpha if eng else 0) * kv_tokens),
                kv_tokens=kv_tokens,
                decode_tok_per_s=1.0 / max(prof.t_decode, 1e-9)))
        plan = plan_degradation(shortfall, engines,
                                next(iter(self.profiles.values())).hw)
        return None if plan is None else plan.c_deg

    def make_room(self, r_need: float) -> None:
        """Degradation levels 0-2 (Algorithm 2's cheap prefix) on the live
        node: trim cached-but-unreferenced prefix pages first, then sleep
        idle engines, then drop sleeping warm contexts, until r_need fits.
        In-flight engines are never touched."""
        idx = self.arena.prefix_index
        if idx is not None:
            while idx.entries and not self.acc.can_admit(r_need):
                if not idx.trim(8):                   # level 0
                    break
        busy = self._busy_models()
        for m in list(self.residency.lru["gpu"]):
            if self.acc.can_admit(r_need):
                return
            if m not in busy and self.residency.state[m] is ModelState.RUNNING:
                self.sleep(m)                         # level 1
        for m, st in list(self.residency.state.items()):
            if self.acc.can_admit(r_need):
                return
            if m not in busy and st is ModelState.SLEEPING:
                self.residency.demote_context(m)      # level 2
                self.acc.unregister_context(m)

    def has_work(self) -> bool:
        """True while any colocated engine has waiting or active requests."""
        return any(e.waiting or e.active for e in self.engines.values())

    def step(self) -> Dict[str, list]:
        out = {}
        for name, eng in self.engines.items():
            if (eng.waiting or eng.active) and name not in self.device_params:
                self.activate(name)   # self-heal: offloaded with queued work
            if name in self.device_params and (eng.waiting or eng.active):
                eng.step()
            if eng.finished:
                out[name] = eng.finished[:]
                eng.finished.clear()
        return out

    # -------------------------------------------------------------- signals
    def kv_overcommit_ratio(self) -> float:
        """Total virtual KV the colocated engines advertise over the PEAK
        physical KV ever mapped in the shared arena (> 1: spatial
        multiplexing is really happening); 0.0 until any KV was mapped."""
        if self.arena.peak_mapped_bytes <= 0:
            return 0.0
        virt = sum(e.pool.virtual_total() for e in self.engines.values())
        return virt / self.arena.peak_mapped_bytes

    def kv_stats(self) -> Dict[str, float]:
        """Arena/overcommit snapshot consumed by gateway end-of-run
        metrics, as one picklable dict."""
        out = {"n_engines": len(self.engines),
               "kv_overcommit_ratio": self.kv_overcommit_ratio(),
               "arena_peak_pages": int(self.arena.peak_mapped_pages),
               "arena_utilization": float(self.arena.utilization()),
               "pages_aliased": int(self.arena.pages_aliased),
               "cow_copies": int(self.arena.cow_copies),
               # iteration-scheduler telemetry, summed over engines
               "engine_prefill_tokens": sum(
                   e.stat_prefill_tokens for e in self.engines.values()),
               "engine_decode_tokens": sum(
                   e.stat_decode_tokens for e in self.engines.values()),
               # the reference's count of jit compiles: nothing compiles
               "engine_prefill_compiles": 0,
               "engine_fused_steps": sum(
                   e.stat_fused_steps for e in self.engines.values()),
               "engine_steps": sum(
                   e.stat_steps for e in self.engines.values()),
               # decode-horizon telemetry: fused multi-token launches and
               # host round-trips (one per horizon launch vs one per token)
               "engine_horizon_steps": sum(
                   e.stat_horizon_steps for e in self.engines.values()),
               "engine_decode_syncs": sum(
                   e.stat_decode_syncs for e in self.engines.values())}
        if self.arena.prefix_index is not None:
            out.update(self.arena.prefix_index.stats())
        return out

    @property
    def page_tokens(self) -> int:
        return self.arena.page_tokens

    def signal(self) -> NodeSignal:
        warm = {m: self.residency.activation_latency(m)
                for m in self.residency.warm_set()}
        qd = float(np.mean([len(e.waiting) for e in self.engines.values()])
                   ) if self.engines else 0.0
        return NodeSignal(node_id=self.node_id, cluster_id=self.cluster_id,
                          headroom=self.acc.headroom, queue_delay_s=qd,
                          warm_models=warm, total_hbm=self.acc.m_total,
                          prefix_digests=self.arena.prefix_digest_summary())
