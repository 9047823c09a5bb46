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

One difference from the reference: a cold model whose weights the GPU tier
cannot take while the models it would have to evict are in flight is
refused by :meth:`NodeRuntime.can_admit`, and a request that reaches
:meth:`NodeRuntime.submit` in that state waits on the node (``deferred``)
until :meth:`NodeRuntime.step` can activate its model; meanwhile the node
admits nothing, so the in-flight work drains. The reference's accountant
admits such a model when the budget holds both weights, and its ``submit``
then raises "cannot activate". The two agree wherever the tier holds every
model the node serves.

The node also keeps a record of each activation and offload it ran
(:attr:`NodeRuntime.activations`, :attr:`NodeRuntime.offloads`), which the
reference does not.
"""
from __future__ import annotations

import collections
import dataclasses
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
from repro_torch.serving.engine import Engine, PromptTooLongError, Request
from repro_torch.serving.kv_arena import KVArena
from repro_torch.serving.prefix_cache import PrefixCacheConfig

Weights = Dict[str, torch.Tensor]       # parameter name -> tensor


def _tree_bytes(weights: Weights) -> int:
    return sum(t.nbytes for t in weights.values())


@dataclasses.dataclass
class Activation:
    """One activation a node ran."""
    model: str
    state_before: str       # the residency state the model left
    cause: str              # "call", "submit", "deferred" or "self-heal"
    req_ids: list           # the requests it was run for
    t_act_s: float          # the residency model's prediction of it
    seconds: float          # measured, the offloads it ran included
    offload_s: float        # the part of ``seconds`` those offloads took
    deferred_s: float = 0.0  # longest wait on the node of those requests


@dataclasses.dataclass
class Offload:
    """One offload a node ran: the weight bytes the accountant let go and
    the drop in allocated device memory (None off CUDA)."""
    model: str
    weight_bytes: float
    freed_bytes: Optional[int]
    seconds: float


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
        # requests whose model cannot be activated until the in-flight
        # models filling the GPU tier drain (see :meth:`submit`)
        self.deferred: Dict[str, collections.deque] = {}
        self.activations: list = []     # Activation, in order
        self.offloads: list = []        # Offload, in order
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
    def activate(self, name: str, cause: str = "call",
                 req_ids=(), deferred_s: float = 0.0) -> float:
        """Make `name` servable; returns measured activation seconds and
        appends an :class:`Activation` (``cause``, ``req_ids`` and
        ``deferred_s`` say what it was run for) to :attr:`activations`."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # time this work alone
        state, t_act = self.residency.state[name].value, self.t_act(name)
        n_off = len(self.offloads)
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
        seconds = time.perf_counter() - t0
        self.activations.append(Activation(
            name, state, cause, list(req_ids), t_act, seconds,
            sum((o.seconds for o in self.offloads[n_off:]), 0.0),
            deferred_s))
        return seconds

    def _offload(self, name: str) -> None:
        """Device -> host: the weights leave the card (the host tier already
        holds them) and the engine object stays. The engine's KV — arena
        pages, prefix pins, block tables and the dense state cache — is
        freed and de-accounted here: an offloaded model holds no silent
        device-resident KV. Appends an :class:`Offload` to
        :attr:`offloads`."""
        on_card = self.device.type == "cuda"
        t0 = time.perf_counter()
        before = torch.cuda.memory_allocated(self.device) if on_card else 0
        weight_bytes = self.acc.weights.get(name, 0.0)
        eng = self.engines.get(name)
        if eng is not None:
            eng.release_kv()
        self.device_params.pop(name, None)
        self._drop_weights(self.zoo[name])
        self.acc.unregister_weights(name)
        if self.residency.state[name] is ModelState.CPU:
            self.acc.unregister_context(name)
        freed = (before - torch.cuda.memory_allocated(self.device)
                 if on_card else None)
        self.offloads.append(Offload(name, weight_bytes, freed,
                                     time.perf_counter() - t0))

    def sleep(self, name: str) -> None:
        self.residency.sleep(name)
        self._offload(name)

    # -------------------------------------------------------------- serving
    def submit(self, model: str, req: Request) -> None:
        """Hand ``req`` to the model's engine, activating the model first.
        When the GPU tier cannot take the model until in-flight models
        drain, the request waits on the node and :meth:`step` submits it
        once the model can be activated; its TTFT clock starts here."""
        if model not in self.device_params:
            if not self._tier_fits(model):
                if len(req.tokens) > self.s_max - 1:
                    raise PromptTooLongError(
                        f"prompt of {len(req.tokens)} tokens exceeds the "
                        f"engine window (s_max={self.s_max}, >=1 decode "
                        f"slot required)")
                if not req.submit_s:
                    req.submit_s = time.perf_counter()
                self.deferred.setdefault(model, collections.deque()
                                         ).append(req)
                return
            self.activate(model, "submit", [req.req_id])
        self.engines[model].submit(req)

    def preempt(self, model: str, req_id: int) -> Optional[Request]:
        """Boundary-preempt a request on this node (waiting or active);
        returns the withdrawn Request (partial output discarded) or None."""
        for req in self.deferred.get(model, ()):
            if req.req_id == req_id:
                self.deferred[model].remove(req)
                return req
        eng = self.engines.get(model)
        return None if eng is None else eng.evict(req_id)

    def t_act(self, model: str) -> float:
        """Estimated activation latency (no side effects) — the T_act of
        Eq. 6 that the cross-cluster router consumes."""
        return self.residency.activation_latency(model)

    # ----------------------------------------------- admission (Alg. 2 aware)
    def _busy_models(self) -> set:
        return {m for m, e in self.engines.items() if e.active or e.waiting}

    def _tier_fits(self, model: str) -> bool:
        """Whether the GPU tier can take ``model`` now: the resident models
        with work in flight stay (activation evicts only idle ones), so
        they and ``model`` must fit its capacity together."""
        res = self.residency
        if res.state[model] is ModelState.RUNNING:
            return True
        busy = self._busy_models()
        keep = sum(size for m, size in res.lru["gpu"].items() if m in busy)
        return keep + res.size(model) <= res.cap["gpu"]

    def can_admit(self, r_need: float, model: Optional[str] = None) -> bool:
        """Eviction-aware KV admission feasibility: everything except
        in-flight models' weights and contexts can be reclaimed by
        degradation levels 1-2 before the stage lands. A cold model the
        GPU tier cannot take beside the in-flight ones is refused, and so
        is any model while requests wait for an activation here: the node
        drains the work that keeps them out."""
        extra = 0.0
        if model is not None and (not self._tier_fits(model)
                                  or any(self.deferred.values())):
            return False
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
        """True while any colocated engine has waiting or active requests,
        or a request waits for its model's activation."""
        return (any(e.waiting or e.active for e in self.engines.values())
                or any(self.deferred.values()))

    def step(self) -> Dict[str, list]:
        out = {}
        for name in [m for m, q in self.deferred.items() if q]:
            # asked again for each model: activating an earlier one in this
            # loop puts it in flight, and the tier may no longer take this
            if not self._tier_fits(name):
                continue
            reqs = self.deferred.pop(name)
            if name not in self.device_params:
                now = time.perf_counter()
                self.activate(name, "deferred", [r.req_id for r in reqs],
                              max(now - r.submit_s for r in reqs))
            for req in reqs:
                self.engines[name].submit(req)
        for name, eng in self.engines.items():
            if (eng.waiting or eng.active) and name not in self.device_params:
                # self-heal: offloaded with queued work
                self.activate(name, "self-heal")
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
