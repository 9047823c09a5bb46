"""Substrate-agnostic scheduling interface: the seam between policies and
the serving planes.

The paper's central claim is a CONTROLLED comparison — fcfs / edf /
oracle-srtf / maestro(-np) and the Table VIII routing variants differ only
in admission, routing and queue order. This module makes that structural:
a policy sees stages only through the :class:`SchedStage` view and a plane
only through the :class:`Substrate` protocol, so the exact same policy
object schedules the trace-driven simulator (``repro_torch.sim.simulator``) and
the live real-engine gateway (``repro_torch.serving.gateway``).

Substrate time is opaque to policies: the simulator's clock runs in model
seconds, the gateway's in whatever its pluggable clock provides (virtual
tick seconds by default, real elapsed seconds under the wall clock — see
``repro_torch.serving.clock``). All durations a policy touches (``t_exec_est``,
``true_remaining_s``, ``preempt_gain_s``, the ``job_remaining_s`` it
records on finish) are expressed in SECONDS on the substrate's own clock —
never in ticks — so relative ordering (the only thing scheduling decisions
depend on) is preserved across planes and across clocks, and hysteresis
thresholds like ``preempt_gain_s`` are clock-independent.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Protocol, Sequence, runtime_checkable

import numpy as np

from repro_torch.core.predictor.cost_model import ModelProfile
from repro_torch.core.predictor.features import StageObservation
from repro_torch.core.sched.fitness import NodeSignal


@dataclasses.dataclass(frozen=True)
class SchedStage:
    """What a policy is allowed to know about a stage: identity, model,
    prompt size, SLO class and the job's arrival/deadline. Ground truth
    (true output lengths) is NOT here — oracle knowledge goes through
    ``Substrate.true_remaining_s`` so its use is explicit."""
    stage_id: int
    job_id: int
    model: str                 # serving-model name (a key of sub.profiles)
    interactive: bool          # SLO class
    prompt_len: int            # trace-scale prompt length (cost-model input)
    arrival_s: float           # job arrival on the substrate clock
    deadline_s: float          # job SLO deadline, relative to arrival
    obs: StageObservation      # full observation (predictor input)


@runtime_checkable
class Substrate(Protocol):
    """What a serving plane exposes to policies. Implemented by
    ``repro_torch.sim.simulator.Simulator`` and
    ``repro_torch.serving.gateway.ClusterGateway``."""

    profiles: Dict[str, ModelProfile]
    rtt_s: np.ndarray                 # canonical cluster RTT matrix
    preempt_gain_s: float             # boundary-preemption hysteresis
    preempt_cooldown_s: float         # per-job preemption cooldown

    # ------------------------------------------------------------- fleet
    def node_ids(self) -> Sequence[int]:
        """All node ids, in stable order."""

    def signal(self, node_id: int) -> NodeSignal:
        """Current NodeSignal (headroom / queue delay / warm set) of a node."""

    def load(self, node_id: int) -> int:
        """In-flight stage count on a node (least-loaded routing input)."""

    def can_admit(self, node_id: int, r_need: float,
                  model: Optional[str] = None) -> bool:
        """Eviction-aware admission feasibility: slot available AND r_need
        bytes admissible, counting what Alg. 2 degradation could free."""

    def t_act(self, node_id: int, model: str) -> float:
        """Estimated activation latency T_act (Eq. 6), no side effects."""

    def degradation_cost(self, node_id: int, r_need: float) -> Optional[float]:
        """C_deg of admitting r_need via an Algorithm 2 plan (0.0 when no
        degradation is needed, None when impossible)."""

    # ------------------------------------------------------------- stages
    def known_stages(self) -> List[SchedStage]:
        """Stages known up-front (trace replay); [] for online arrivals.
        Lets predictive policies batch-precompute at setup time."""

    def static_reservation(self, stage: SchedStage) -> float:
        """Non-predictive KV reservation (baseline policies' R_need)."""

    def t_exec_est(self, stage: SchedStage, l_hat: Optional[float]) -> float:
        """Estimated stage execution time on the substrate clock for a
        predicted output length; l_hat=None means the substrate's nominal
        decode budget (non-predictive estimate)."""

    def true_remaining_s(self, stage: SchedStage) -> float:
        """TRUE remaining execution time of the stage's job including this
        stage (oracle knowledge — only Oracle-SRTF may call this)."""

    def ready_since(self, stage_id: int) -> float:
        """Substrate time the stage entered the global queue (aging input);
        +inf when unknown (treated as zero wait)."""

    def prefix_digests(self, stage: SchedStage) -> Sequence[str]:
        """Chained prefix-page digests of the stage's prompt, for
        prefix-affinity routing; () on planes without token-level prompts
        (the trace simulator) or when the prefix cache is disabled."""
