"""Feasibility-aware cross-cluster fitness routing (§III.D, Eq. 5-6, Alg. 3).

    S(N, T) = A(N, T) - lambda * T_ready(N, T) - mu * C_deg(N, T)

A(N,T) combines network proximity (decreasing transform of RTT) with KV-fit
best-fit packing over the runtime-reported headroom. All metrics pass through
robust 5/95-percentile min-max normalization over a recent window so outlier
RTT or activation estimates cannot dominate. T_ready = T_q + T_act (Eq. 6).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np


class RobustNormalizer:
    """Rolling per-metric 5/95-percentile min-max with clipping."""

    def __init__(self, window: int = 256):
        self.hist: Dict[str, Deque[float]] = collections.defaultdict(
            lambda: collections.deque(maxlen=window))

    def observe(self, metric: str, value: float) -> None:
        self.hist[metric].append(float(value))

    def norm(self, metric: str, value: float) -> float:
        h = self.hist[metric]
        if len(h) < 4:
            return 0.0 if value <= 0 else 0.5
        a = np.asarray(h)
        lo, hi = np.percentile(a, 5), np.percentile(a, 95)
        if hi - lo < 1e-12:
            return 0.5
        return float(np.clip((value - lo) / (hi - lo), 0.0, 1.0))


@dataclasses.dataclass
class NodeSignal:
    """What each node runtime periodically reports to the global scheduler."""
    node_id: int
    cluster_id: int
    headroom: float                    # R_kv_head(N)
    queue_delay_s: float               # EWMA'd T_q
    warm_models: Dict[str, float]      # model -> T_act seconds (Eq. 6)
    supports_vmm: bool = True          # elastic-KV capability signal
    total_hbm: float = 80e9            # one H100's HBM
    # most-recent prefix-page digests held by the node's prefix index
    # (compact content summary; rides the existing signal snapshot)
    prefix_digests: Tuple[str, ...] = ()


@dataclasses.dataclass
class StageRequest:
    stage_id: int
    model: str
    r_need: float                      # (1+rho) * R_kv_hat
    interactive: bool
    src_cluster: int
    t_exec: float                      # Eq. 2 (node-invariant)
    high_concurrency: bool = False
    # chained page digests of the stage's prompt (empty: no prefix routing)
    prefix_digests: Tuple[str, ...] = ()


@dataclasses.dataclass
class FitnessWeights:
    w_net: float = 0.5
    w_fit: float = 0.5
    lam: float = 1.0
    mu: float = 1.0
    # interactive stages weight the network term up (§III.D)
    w_net_interactive: float = 0.75
    # prefix-affinity term: reward nodes already holding the stage's prompt
    # prefix (0 keeps scoring identical to the base router)
    w_prefix: float = 0.0


class FitnessRouter:
    """Algorithm 3."""

    def __init__(self, rtt_s: np.ndarray,
                 weights: Optional[FitnessWeights] = None,
                 gamma: float = 0.25):
        """rtt_s[c1, c2] = RTT between clusters (seconds).
        gamma scales the network component (0 => BinPack-only baseline)."""
        self.rtt = rtt_s
        self.w = weights or FitnessWeights()
        self.gamma = gamma
        self.normalizer = RobustNormalizer()

    def affinity(self, rtt: float, headroom: float, r_need: float,
                 interactive: bool) -> float:
        w_net = self.w.w_net_interactive if interactive else self.w.w_net
        w_net *= self.gamma / 0.25 if self.gamma else 0.0
        net = 1.0 - self.normalizer.norm("rtt", rtt)
        # best-fit packing: prefer nodes whose headroom is close to r_need
        # (from above) among feasible candidates
        slack = (headroom - r_need) / max(headroom, 1e-9)
        fit = 1.0 - float(np.clip(slack, 0.0, 1.0))
        return w_net * net + self.w.w_fit * fit

    def score(self, sig: NodeSignal, req: StageRequest,
              t_act: float, c_deg: float) -> float:
        rtt = float(self.rtt[req.src_cluster, sig.cluster_id])
        self.normalizer.observe("rtt", rtt)
        t_ready = sig.queue_delay_s + t_act
        self.normalizer.observe("t_ready", t_ready)
        self.normalizer.observe("c_deg", c_deg)
        a = self.affinity(rtt, sig.headroom, req.r_need, req.interactive)
        a += self.w.w_prefix * self.prefix_affinity(sig, req)
        return (a - self.w.lam * self.normalizer.norm("t_ready", t_ready)
                - self.w.mu * self.normalizer.norm("c_deg", c_deg))

    def prefix_affinity(self, sig: NodeSignal, req: StageRequest) -> float:
        """Fraction of the stage's prefix chain the node already holds.

        Digests chain (page i commits to pages 0..i), so the walk stops at
        the first digest the node does not advertise — matching exactly the
        pages the engine could alias on arrival."""
        if not self.w.w_prefix or not req.prefix_digests:
            return 0.0
        held = set(sig.prefix_digests)
        n = 0
        for d in req.prefix_digests:
            if d not in held:
                break
            n += 1
        return n / len(req.prefix_digests)

    def select(self, req: StageRequest, nodes: Sequence[NodeSignal],
               t_act_of, c_deg_of) -> Optional[Tuple[NodeSignal, float]]:
        """Filter by feasibility, rank by S(N,T). ``t_act_of(node, model)`` and
        ``c_deg_of(node, req)`` are runtime estimate callbacks."""
        best, best_s = None, -np.inf
        for sig in nodes:
            c_deg = 0.0
            if sig.headroom < req.r_need:
                # infeasible without degradation: runtime reports plan cost,
                # or None when impossible -> filtered out
                c_deg = c_deg_of(sig, req)
                if c_deg is None:
                    continue
            if req.high_concurrency and not sig.supports_vmm:
                continue  # hard capability constraint
            s = self.score(sig, req, t_act_of(sig, req.model), c_deg)
            if s > best_s:
                best, best_s = sig, s
        if best is None:
            return None
        return best, best_s
