"""The five-phase stage-driven closed-loop control pipeline (§III.A):

  1. agent-context observation   -> StageObservation
  2. cost prediction             -> L_hat, R_kv_hat, p_tool (dispatch gateway)
  3. scheduling decision         -> fitness routing + SRTF queueing
  4. node-level execution        -> residency / accounting / coordination
  5. post-execution profiling    -> predictor calibration (rho, Eq.8 profiles)

``MaestroController`` wires the core components; the discrete-event simulator
(repro_torch.sim) and the real serving engine (repro_torch.serving) both drive it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.predictor.cost_model import ModelProfile
from repro_torch.core.predictor.features import StageObservation
from repro_torch.core.predictor.length_model import MaestroPred
from repro_torch.core.sched.fitness import (FitnessRouter, FitnessWeights,
                                      NodeSignal, StageRequest)
from repro_torch.core.sched.margins import RhoEstimator
from repro_torch.core.sched.srtf import (QueuedStage, SRTFQueue,
                                   WorkflowProfileStore, state_key)


@dataclasses.dataclass
class StagePlan:
    stage_id: int
    node_id: Optional[int]
    score: float
    l_hat: float
    p_tool: float
    r_kv_hat: float
    r_need: float
    t_exec: float
    t_future: float


class MaestroController:
    def __init__(self, predictor: MaestroPred,
                 profiles: Dict[str, ModelProfile],
                 rtt_s: np.ndarray,
                 weights: Optional[FitnessWeights] = None,
                 gamma: float = 0.25,
                 queue: Optional[SRTFQueue] = None):
        self.predictor = predictor
        self.profiles = profiles
        self.router = FitnessRouter(rtt_s, weights, gamma=gamma)
        self.rho = RhoEstimator()
        # callers operating at a different time scale (e.g. the live gateway's
        # tick clock) pass a queue with matching hysteresis thresholds
        self.queue = queue if queue is not None else SRTFQueue()
        self.wf_profiles = WorkflowProfileStore()

    # ------------------------------------------------------------ phase 1+2
    def predict_stage(self, obs: StageObservation) -> Tuple[float, float, float]:
        """Returns (L_hat, p_tool, R_kv_hat)."""
        pred = self.predictor.predict_one(obs)
        prof = self.profiles[model_name(obs, self.profiles)]
        r_kv = prof.r_kv(obs.prompt_len, pred["length"])
        return pred["length"], pred["p_tool"], r_kv

    # -------------------------------------------------------------- phase 3
    def plan(self, stage_id: int, job_id: int, obs: StageObservation,
             interactive: bool, nodes: List[NodeSignal],
             t_act_of, c_deg_of, now: float = 0.0) -> StagePlan:
        l_hat, p_tool, r_kv_hat = self.predict_stage(obs)
        prof = self.profiles[model_name(obs, self.profiles)]
        t_exec = prof.t_exec(obs.prompt_len, l_hat)
        r_need = self.rho.r_need(r_kv_hat)
        req = StageRequest(stage_id=stage_id,
                           model=prof.name, r_need=r_need,
                           interactive=interactive,
                           src_cluster=obs.src_cluster, t_exec=t_exec)
        sel = self.router.select(req, nodes, t_act_of, c_deg_of)
        key = state_key(obs.app, obs.role, obs.invocation_idx, p_tool)
        t_future = self.wf_profiles.future_median(key)
        return StagePlan(
            stage_id=stage_id,
            node_id=None if sel is None else sel[0].node_id,
            score=-np.inf if sel is None else sel[1],
            l_hat=l_hat, p_tool=p_tool, r_kv_hat=r_kv_hat, r_need=r_need,
            t_exec=t_exec, t_future=t_future)

    def enqueue(self, plan: StagePlan, job_id: int, interactive: bool,
                now: float) -> QueuedStage:
        qs = QueuedStage(stage_id=plan.stage_id, job_id=job_id,
                         interactive=interactive, t_exec=plan.t_exec,
                         t_future=plan.t_future, enqueue_time=now)
        self.queue.push(qs, now)
        return qs

    # -------------------------------------------------------------- phase 5
    def observe_completion(self, obs: StageObservation, plan: StagePlan,
                           actual_len: float, actual_kv: float,
                           job_remaining_after_s: float) -> None:
        """Post-execution profiling: calibrate rho + Eq. 8 profiles."""
        self.rho.observe(actual_kv, max(plan.r_kv_hat, 1.0))
        key = state_key(obs.app, obs.role, obs.invocation_idx, plan.p_tool)
        self.wf_profiles.record(key, job_remaining_after_s)


def model_name(obs: StageObservation, profiles: Dict[str, ModelProfile]) -> str:
    """Deterministic model assignment shared by every plane that consumes the
    controller: observation model ids map onto the sorted profile names, so
    predictions, routing and live execution all agree on the serving model."""
    names = sorted(profiles)
    return names[obs.model_id % len(names)]


_model_name = model_name  # backwards-compatible alias
