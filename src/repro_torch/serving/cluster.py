"""Live cluster topology: fleets of real ``NodeRuntime`` engines spread
across simulated-RTT clusters; the port of the fleet half of
``repro/serving/cluster.py``.

Every node holds the same model zoo (reduced configs, structurally
faithful) with weights from one shared host registry; cross-cluster
effects (RTT, cold starts) enter through the gateway's virtual clock.
Nodes live in the gateway's process (``backend="inproc"``), in worker
processes of their own (``"process"``), or behind the socket transport
(``"socket"``), each worker building its node from the picklable spec of
:func:`worker_specs`. The trace adapter (``LiveStage``, ``LiveJob``,
``jobs_from_trace``) turns generated traces into live jobs for the
gateway, as the reference's does.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.predictor.features import StageObservation
from repro_torch.core.topology import DEFAULT_RTT
from repro_torch.data.tracegen import JobRecord
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


def build_zoo(model_names: Sequence[str] = DEFAULT_ZOO, seed: int = 1,
              reduced: bool = True, device=None
              ) -> Tuple[Dict[str, Model], Dict[str, Any]]:
    """Tiny real models (reduced configs) + their host-memory parameter
    trees, drawn by :func:`init_params` from ``seed + i`` for the i-th
    model. The host trees are shared by every node of the fleet (a model
    registry), as weights would be fetched from common storage.

    ``reduced=False`` builds the full-width configs instead: each model's
    weights are drawn on ``device`` (``cuda`` unless the caller names
    another), as the full-width serving runs draw them, and copied into one
    host tree, pinned when drawn on CUDA. A full-width worker builds its
    zoo so; ``device`` is ignored for the reduced configs."""
    zoo, host = {}, {}
    for i, name in enumerate(model_names):
        cfg = get_config(name)
        if reduced:
            cfg = cfg.reduced()
            gen = torch.Generator().manual_seed(seed + i)
            host[name] = init_params(cfg, gen, "cpu")
        else:
            dev = resolve_device(device)
            drawn = build_model(cfg, device=dev, seed=seed + i)
            host[name] = _host_copy(drawn.param_tree())
            del drawn
            if dev.type == "cuda":
                torch.cuda.empty_cache()     # the drawn copy's blocks
        zoo[name] = build_model(cfg, host[name], device="cpu")
    return zoo, host


def _host_copy(tree):
    """A parameter tree in host memory: CUDA leaves copied into pinned
    host tensors, CPU leaves kept as they are."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_host_copy(v) for v in tree]
    if not tree.is_cuda:
        return tree
    return torch.empty(tree.shape, dtype=tree.dtype,
                       pin_memory=True).copy_(tree)


def worker_specs(spec: ClusterSpec, seed: int = 1, device=None,
                 reduced: bool = True) -> List[Any]:
    """The picklable per-node ``WorkerSpec`` list for a cluster spec —
    what both worker backends ship to their children, and what
    ``connect_fleet`` sends to standalone remote workers. ``device``: each
    node's device (``cuda`` when None); ``reduced=False``: full-width
    models (see :func:`build_zoo`)."""
    from repro_torch.serving.worker import WorkerSpec
    return [WorkerSpec(node_id=nid, cluster_id=ns.cluster_id,
                       model_names=tuple(spec.model_names),
                       hbm_budget=ns.hbm_budget, max_slots=ns.max_slots,
                       s_max=ns.s_max, seed=seed,
                       prefix_cache=ns.prefix_cache or None,
                       prefix_cache_pages=(ns.prefix_cache_pages
                                           if ns.prefix_cache else None),
                       max_batch_tokens=ns.max_batch_tokens,
                       prefill_chunk_tokens=(ns.prefill_chunk_tokens
                                             or None),
                       decode_horizon=(ns.decode_horizon
                                       if ns.decode_horizon > 1 else None),
                       device=None if device is None else str(device),
                       reduced=reduced)
            for nid, ns in enumerate(spec.nodes)]


def build_fleet(spec: Optional[ClusterSpec] = None,
                zoo: Optional[Dict[str, Model]] = None,
                host: Optional[Dict[str, Any]] = None,
                seed: int = 1, backend: str = "inproc",
                device=None,
                worker_addresses: Optional[Sequence[Any]] = None
                ) -> List[Any]:
    """Instantiate the fleet; node ids are positional.

    ``backend="inproc"`` (default) returns in-process ``NodeRuntime``
    objects: ``zoo`` supplies the models' configs and ``host`` their
    weights (both from :func:`build_zoo` by default), and each node serves
    Models of its own over the shared host trees. ``backend="process"``
    spawns one worker process per node and returns ``NodeHandle`` proxies
    (each child builds its own zoo from the same ``model_names`` + ``seed``,
    so the fleets are numerically identical — ``zoo``/``host`` are ignored
    there); ``backend="socket"`` speaks the same protocol over the framed
    TCP transport — localhost children by default, or, when
    ``worker_addresses`` gives one "host:port" per node, workers already
    listening elsewhere (started with ``python -m
    repro_torch.serving.worker --listen``). ``device``: every node's
    device, ``cuda`` unless the caller names another; a worker gets it in
    its spec."""
    spec = spec or ClusterSpec()
    if worker_addresses is not None and backend != "socket":
        raise ValueError("worker_addresses requires backend='socket'")
    if backend in ("process", "socket"):
        from repro_torch.serving.worker import connect_fleet, spawn_fleet
        specs = worker_specs(spec, seed=seed, device=device)
        if worker_addresses is not None:
            return connect_fleet(worker_addresses, specs)
        return spawn_fleet(specs, backend=backend)
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


# ---------------------------------------------------------------------------
# Trace adapter: simulator JobRecords -> live jobs with real token prompts
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LiveStage:
    stage_id: int
    job_id: int
    deps: List[int]
    obs: StageObservation
    interactive: bool
    tokens: List[int]             # real prompt token ids
    max_new: int                  # decode budget (ground-truth len, capped)
    nominal_len: int = 0          # uncapped trace-scale output length; the
                                  # calibration target for L_hat (0 => max_new)


@dataclasses.dataclass
class LiveJob:
    job_id: int
    app: str
    interactive: bool
    arrival_s: float
    stages: List[LiveStage]
    deadline_s: float = 0.0       # filled by the gateway's SLO profiler


def _block_tokens(key: str, n: int, vocab: int) -> List[int]:
    """Token ids of a named prompt block, derived from the key ALONE (an
    rng seeded from the key's hash) — equal keys materialize to identical
    tokens in any job/stage, which is precisely the shared-prefix property
    the cross-stage prefix cache exploits. Does not touch the trace-level
    rng, so classic (block-free) traces stay byte-identical."""
    h = hashlib.blake2b(key.encode(), digest_size=8).digest()
    r = np.random.default_rng(int.from_bytes(h, "big"))
    return [int(x) for x in r.integers(0, vocab, n)]


def jobs_from_trace(trace_jobs: Sequence[JobRecord], vocab: int = 512,
                    prompt_cap: int = 16, gen_cap: int = 16,
                    n_clusters: int = 3, seed: int = 0) -> List[LiveJob]:
    """Instantiate real token payloads for a generated trace. Prompt/output
    lengths are capped so tiny smoke models execute quickly; the ORIGINAL
    observation (with its uncapped prompt_len and semantic text) is kept, so
    the predictor and router see the workload the trace describes.

    Stages carrying ``prompt_blocks`` (team traces) get their tokens from
    the named blocks instead of the shared rng: block-structured prompts
    with identical leading blocks share identical leading tokens."""
    rng = np.random.default_rng(seed)
    out: List[LiveJob] = []
    for j in trace_jobs:
        stages = []
        for s in j.stages:
            obs = s.obs
            if obs.src_cluster >= n_clusters:
                obs = dataclasses.replace(obs,
                                          src_cluster=obs.src_cluster
                                          % n_clusters)
            blocks = getattr(s, "prompt_blocks", None)
            if blocks:
                tokens: List[int] = []
                for key, n in blocks:
                    tokens += _block_tokens(key, n, vocab)
            else:
                p = int(np.clip(s.obs.prompt_len // 32, 4, prompt_cap))
                tokens = list(rng.integers(0, vocab, p))
            stages.append(LiveStage(
                stage_id=s.stage_id, job_id=j.job_id, deps=list(s.deps),
                obs=obs, interactive=s.interactive,
                tokens=tokens,
                max_new=int(np.clip(s.true_len // 16, 4, gen_cap)),
                nominal_len=int(s.true_len)))
        out.append(LiveJob(job_id=j.job_id, app=j.app,
                           interactive=j.interactive,
                           arrival_s=j.arrival_s, stages=stages))
    return out
