"""Live cluster topology: fleets of real ``NodeRuntime`` engines spread
across simulated-RTT clusters; the port of the fleet half of
``repro/serving/cluster.py``.

Every node holds the same model zoo (reduced configs, structurally
faithful) with weights from one shared host registry; cross-cluster
effects (RTT, cold starts) enter through the gateway's virtual clock.
Only in-process nodes exist so far: the worker-process and socket backends
and the trace adapter (``LiveStage``, ``LiveJob``, ``jobs_from_trace``)
come with the gateway.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.topology import DEFAULT_RTT
from repro_torch.models import build_model, init_params
from repro_torch.models.transformer import Model
from repro_torch.serving.node_runtime import NodeRuntime

# default live zoo: three distinct families colocated per node (attention,
# code-tuned attention, SSM) — the Table-IV colocation regime in miniature
DEFAULT_ZOO = ("qwen3-8b", "starcoder2-15b", "mamba2-2.7b")


@dataclasses.dataclass
class NodeSpec:
    cluster_id: int
    hbm_budget: float = 1.2e9
    max_slots: int = 4
    s_max: int = 64
    # cross-stage prefix-cache plane (off by default)
    prefix_cache: bool = False
    prefix_cache_pages: int = 256
    # engine iteration scheduler (0 = monolithic prefill; > 0 streams
    # prompts in fixed-width chunks fused with decode, budgeted by
    # max_batch_tokens per iteration)
    max_batch_tokens: Optional[int] = None
    prefill_chunk_tokens: int = 0
    # decode horizon (1 = one host sync per decode iteration; H > 1 runs up
    # to H decode iterations per launch with one host sync)
    decode_horizon: int = 1


@dataclasses.dataclass
class ClusterSpec:
    """Fleet description consumed by ``build_fleet``."""
    nodes: Tuple[NodeSpec, ...] = (NodeSpec(0), NodeSpec(0, hbm_budget=0.8e9),
                                   NodeSpec(1))
    rtt_s: np.ndarray = dataclasses.field(
        default_factory=lambda: DEFAULT_RTT.copy())
    model_names: Tuple[str, ...] = DEFAULT_ZOO

    @property
    def n_clusters(self) -> int:
        return int(max(n.cluster_id for n in self.nodes)) + 1


def build_zoo(model_names: Sequence[str] = DEFAULT_ZOO, seed: int = 1
              ) -> Tuple[Dict[str, Model], Dict[str, Any]]:
    """Tiny real models (reduced configs) + their host-memory parameter
    trees, drawn by :func:`init_params` from ``seed + i`` for the i-th
    model. The host trees are shared by every node of the fleet (a model
    registry), as weights would be fetched from common storage."""
    zoo, host = {}, {}
    for i, name in enumerate(model_names):
        cfg = get_config(name).reduced()
        gen = torch.Generator().manual_seed(seed + i)
        host[name] = init_params(cfg, gen, "cpu")
        zoo[name] = build_model(cfg, host[name], device="cpu")
    return zoo, host


def build_fleet(spec: Optional[ClusterSpec] = None,
                zoo: Optional[Dict[str, Model]] = None,
                host: Optional[Dict[str, Any]] = None,
                seed: int = 1, backend: str = "inproc",
                device=None) -> List[NodeRuntime]:
    """Instantiate the fleet; node ids are positional. ``zoo`` supplies the
    models' configs and ``host`` their weights (both from
    :func:`build_zoo` by default); each node serves Models of its own over
    the shared host trees. Only ``backend="inproc"`` exists in the port.
    ``device``: ``cuda`` unless the caller names another."""
    spec = spec or ClusterSpec()
    if backend in ("process", "socket"):
        raise NotImplementedError(
            f"backend {backend!r}: the worker-process and socket backends "
            f"come with the worker slice of the port")
    if backend != "inproc":
        raise ValueError(f"unknown node backend {backend!r} "
                         "(expected 'inproc', 'process' or 'socket')")
    if zoo is None or host is None:
        zoo, host = build_zoo(spec.model_names, seed=seed)
    fleet = []
    for nid, ns in enumerate(spec.nodes):
        own = {name: Model(m.cfg, host[name]) for name, m in zoo.items()}
        fleet.append(NodeRuntime(nid, ns.cluster_id, own, host,
                                 hbm_budget=ns.hbm_budget,
                                 max_slots=ns.max_slots, s_max=ns.s_max,
                                 prefix_cache=ns.prefix_cache,
                                 prefix_cache_pages=ns.prefix_cache_pages,
                                 max_batch_tokens=ns.max_batch_tokens,
                                 prefill_chunk_tokens=ns.prefill_chunk_tokens,
                                 decode_horizon=ns.decode_horizon,
                                 device=device))
    return fleet
