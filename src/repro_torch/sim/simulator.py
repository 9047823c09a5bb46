"""Trace-driven discrete-event simulator for cross-cluster LLM-MAS serving.

Event loop over (arrival, ready, start, finish); nodes are SimNode instances
(residency + accounting + coordination, simulated time). Execution duration
uses the TRUE output length through the same cost model the scheduler's
predictions use — so prediction error manifests as queueing/admission error
exactly as in the paper.

The simulator is one of the two
:class:`~repro_torch.core.sched.substrate.Substrate` implementations (the
other is the live ``ClusterGateway``): policies from the unified registry
(``repro_torch.core.sched.policies``) drive it through the shared priority /
reservation / route / on_finish surface.

Boundary preemption semantics (§III.D): with ``requeue_at_boundary`` the
successor of a finished stage re-enters the global queue and contends under
the policy's order; without it, job continuity keeps the successor on the
same node ahead of the queue (run-to-completion), which is what lets long
batch workflows block interactive work (Table II).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.predictor.cost_model import (HardwareSpec,
                                                   ModelProfile,
                                                   synthetic_profile)
from repro_torch.core.sched.policies import SchedPolicy, make_policy
from repro_torch.core.sched.substrate import SchedStage
from repro_torch.core.topology import DEFAULT_RTT, validate_rtt
from repro_torch.data.apps import APPS, APP_ID, MODELS, MODEL_PARAMS_B
from repro_torch.data.tracegen import JobRecord, StageRecord
from repro_torch.sim.cluster import SimNode


@dataclasses.dataclass
class SimConfig:
    nodes_per_cluster: Tuple[int, ...] = (2, 2, 1)
    hbm: float = 40e9
    max_concurrency: int = 8
    reserve_len: int = 2048          # baseline (non-predictive) KV reservation
    interactive_wait_budget_s: float = 2.0
    slo_factor: float = 2.0
    preempt_gain_s: float = 1.0      # boundary-preemption hysteresis
    preempt_cooldown_s: float = 5.0
    seed: int = 0


@dataclasses.dataclass
class SimResult:
    policy: str
    slo_attainment: float
    mean_latency_s: float
    interactive_queue_delay_s: float
    p95_latency_s: float
    finished_jobs: int
    cold_starts: int
    preemptions: int

    def row(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def default_profiles(hw: Optional[HardwareSpec] = None) -> Dict[str, ModelProfile]:
    hw = hw or HardwareSpec(name="a100-40g", peak_flops=312e12, hbm_bw=1555e9,
                            hbm_capacity=40e9, host_link_bw=25e9)
    return {name: synthetic_profile(name, b, hw)
            for name, b in zip(MODELS, MODEL_PARAMS_B)}


class Simulator:
    """The SIM-plane Substrate: simulated time, true-length execution."""

    def __init__(self, jobs: Sequence[JobRecord],
                 policy: Union[SchedPolicy, str],
                 cfg: Optional[SimConfig] = None,
                 profiles: Optional[Dict[str, ModelProfile]] = None,
                 rtt: Optional[np.ndarray] = None):
        self.cfg = cfg or SimConfig()
        self.jobs = {j.job_id: j for j in jobs}
        self.policy = (make_policy(policy) if isinstance(policy, str)
                       else policy)
        self.profiles = profiles or default_profiles()
        self.rtt_s = validate_rtt(rtt if rtt is not None else DEFAULT_RTT)
        self.preempt_gain_s = self.cfg.preempt_gain_s
        self.preempt_cooldown_s = self.cfg.preempt_cooldown_s
        self.nodes: List[SimNode] = []
        nid = 0
        for c, n in enumerate(self.cfg.nodes_per_cluster):
            for _ in range(n):
                self.nodes.append(SimNode(nid, c, self.profiles,
                                          hbm=self.cfg.hbm,
                                          max_concurrency=self.cfg.max_concurrency))
                nid += 1
        self._set_deadlines(jobs)

        # state
        self.done: set = set()
        self.ready_at: Dict[int, float] = {}
        self.stage_wait: Dict[int, float] = {}
        self.stage_by_id: Dict[int, StageRecord] = {
            s.stage_id: s for j in jobs for s in j.stages}
        self.pending_deps: Dict[int, int] = {}
        self.job_done_stages: Dict[int, int] = {j.job_id: 0 for j in jobs}
        self.job_finish: Dict[int, float] = {}
        self.cold_starts = 0
        self.preemptions = 0
        self.waiting: List[Tuple[float, int, int]] = []   # priority heap
        self._views: Dict[int, SchedStage] = {
            s.stage_id: self._make_view(s) for j in jobs for s in j.stages}
        self.policy.setup(self)

    # --------------------------------------------------- Substrate protocol
    def node_ids(self) -> Sequence[int]:
        return range(len(self.nodes))

    def signal(self, node_id: int):
        return self.nodes[node_id].signal()

    def load(self, node_id: int) -> int:
        return len(self.nodes[node_id].running)

    def can_admit(self, node_id: int, r_need: float,
                  model: Optional[str] = None) -> bool:
        return self.nodes[node_id].can_admit(r_need, model)

    def t_act(self, node_id: int, model: str) -> float:
        return self.nodes[node_id].t_act(model)

    def degradation_cost(self, node_id: int,
                         r_need: float) -> Optional[float]:
        return self.nodes[node_id].degradation_cost(r_need)

    def known_stages(self) -> List[SchedStage]:
        return list(self._views.values())

    def static_reservation(self, stage: SchedStage) -> float:
        prof = self.profiles[stage.model]
        return prof.r_kv(stage.prompt_len, self.cfg.reserve_len)

    def t_exec_est(self, stage: SchedStage,
                   l_hat: Optional[float]) -> float:
        if l_hat is None:
            l_hat = float(self.stage_by_id[stage.stage_id].true_len)
        return self.profiles[stage.model].t_exec(stage.prompt_len, l_hat)

    def true_remaining_s(self, stage: SchedStage) -> float:
        job = self.jobs[stage.job_id]
        rem = 0.0
        for st in job.stages:
            if st.stage_id in self.done:
                continue
            prof = self.profiles[st.model]
            rem += prof.t_exec(st.obs.prompt_len, st.true_len)
        return rem

    def ready_since(self, stage_id: int) -> float:
        return self.ready_at.get(stage_id, float("inf"))

    def prefix_digests(self, stage) -> tuple:
        return ()   # trace stages carry no token-level prompts

    def _make_view(self, s: StageRecord) -> SchedStage:
        job = self.jobs[s.job_id]
        return SchedStage(stage_id=s.stage_id, job_id=s.job_id,
                          model=s.model, interactive=job.interactive,
                          prompt_len=s.obs.prompt_len,
                          arrival_s=job.arrival_s, deadline_s=job.deadline_s,
                          obs=s.obs)

    def view(self, stage_id: int) -> SchedStage:
        return self._views[stage_id]

    # ------------------------------------------------------------ deadlines
    def _isolated_time(self, job: JobRecord) -> float:
        """Critical-path exec time with everything warm (SLO profiling)."""
        finish: Dict[int, float] = {}
        for s in job.stages:
            prof = self.profiles[s.model]
            t = prof.t_exec(s.obs.prompt_len, s.true_len)
            start = max((finish[d] for d in s.deps), default=0.0)
            finish[s.stage_id] = start + t
        return max(finish.values())

    def _set_deadlines(self, jobs: Sequence[JobRecord]) -> None:
        per_app: Dict[str, List[float]] = {}
        iso: Dict[int, float] = {}
        for j in jobs:
            t = self._isolated_time(j)
            iso[j.job_id] = t
            per_app.setdefault(j.app, []).append(t)
        p50 = {a: float(np.median(v)) for a, v in per_app.items()}
        for j in jobs:
            j.deadline_s = self.cfg.slo_factor * max(p50[j.app], iso[j.job_id])

    # ------------------------------------------------------------ event loop
    def run(self, horizon_s: float = float("inf")) -> SimResult:
        events: List[Tuple[float, int, str, tuple]] = []
        seq = 0

        def push(t, kind, *args):
            nonlocal seq
            seq += 1
            heapq.heappush(events, (t, seq, kind, args))

        self._push = push
        for j in self.jobs.values():
            push(j.arrival_s, "arrival", j.job_id)

        while events:
            now, _, kind, args = heapq.heappop(events)
            if now > horizon_s:
                break
            if kind == "arrival":
                job = self.jobs[args[0]]
                for s in job.stages:
                    self.pending_deps[s.stage_id] = len(s.deps)
                for s in job.stages:
                    if not s.deps:
                        self._mark_ready(s, now)
            elif kind == "finish":
                node_id, stage_id = args
                node = self.nodes[node_id]
                node.finish(stage_id)
                s = self.stage_by_id[stage_id]
                self.done.add(stage_id)
                job = self.jobs[s.job_id]
                self.job_done_stages[s.job_id] += 1
                if self.job_done_stages[s.job_id] == len(job.stages):
                    self.job_finish[s.job_id] = now
                prof = self.profiles[s.model]
                actual_kv = prof.r_kv(s.obs.prompt_len, s.true_len)
                rem = sum(
                    self.profiles[st.model].t_exec(st.obs.prompt_len,
                                                   st.true_len)
                    for st in job.stages if st.stage_id not in self.done)
                self.policy.on_finish(self, self.view(stage_id), actual_kv,
                                      rem)
                # successors
                succs = [st for st in job.stages
                         if s.stage_id in st.deps]
                for st in succs:
                    self.pending_deps[st.stage_id] -= 1
                    if self.pending_deps[st.stage_id] == 0:
                        if (not self.policy.requeue_at_boundary
                                and self._try_start(st, node, now)):
                            continue  # job continuity: bypass the queue
                        self._mark_ready(st, now)
            self._dispatch(now)
        return self._metrics()

    def _mark_ready(self, s: StageRecord, now: float) -> None:
        self.ready_at[s.stage_id] = now
        pri = self.policy.priority(self, self.view(s.stage_id), now)
        heapq.heappush(self.waiting, (pri, s.stage_id, 0))

    def _try_start(self, s: StageRecord, node: SimNode, now: float) -> bool:
        r_need = self.policy.reservation(self, self.view(s.stage_id))
        if not node.can_admit(r_need, s.model):
            return False
        return self._start_on(s, node, now, r_need)

    def _start_on(self, s: StageRecord, node: SimNode, now: float,
                  r_need: float) -> bool:
        prof = self.profiles[s.model]
        t_act = node.activate(s.model)
        if not node.acc.can_admit(r_need):
            node.make_room(r_need)   # degradation levels 1-2
        if t_act == float("inf") or not node.acc.can_admit(r_need):
            # genuinely infeasible right now: requeue
            heapq.heappush(
                self.waiting,
                (self.policy.priority(self, self.view(s.stage_id), now),
                 s.stage_id, 0))
            return False
        if t_act > 0.01:
            self.cold_starts += 1
        rtt = float(self.rtt_s[s.obs.src_cluster, node.cluster_id])
        dur = prof.t_exec(s.obs.prompt_len, s.true_len)
        finish_at = now + rtt + t_act + dur
        enq = self.ready_at.get(s.stage_id, now)
        self.stage_wait[s.stage_id] = max(0.0, now - enq) + rtt + t_act
        node.start(s.stage_id, s.model, r_need, finish_at, now, enq)
        self._push(finish_at, "finish", node.node_id, s.stage_id)
        return True

    def _dispatch(self, now: float) -> None:
        retry: List[Tuple[float, int, int]] = []
        while self.waiting:
            pri, stage_id, _ = heapq.heappop(self.waiting)
            if stage_id in self.done:
                continue
            s = self.stage_by_id[stage_id]
            view = self.view(stage_id)
            r_need = self.policy.reservation(self, view)
            nid = self.policy.route(self, view, r_need)
            if nid is None:
                retry.append((pri, stage_id, 0))
                # head-of-line: policies block behind their head unless a
                # different-class stage could fit elsewhere
                break
            if not self._start_on(s, self.nodes[nid], now, r_need):
                break  # post-activation admission failed; stage was requeued
        for e in retry:
            heapq.heappush(self.waiting, e)

    # -------------------------------------------------------------- metrics
    def _metrics(self) -> SimResult:
        lat, slo_ok, int_delays = [], [], []
        for j in self.jobs.values():
            if j.job_id not in self.job_finish:
                slo_ok.append(False)
                continue
            l = self.job_finish[j.job_id] - j.arrival_s
            lat.append(l)
            waits = sum(self.stage_wait.get(s.stage_id, 0.0)
                        for s in j.stages)
            if j.interactive:
                int_delays.append(waits)
                slo_ok.append(waits <= self.cfg.interactive_wait_budget_s)
            else:
                slo_ok.append(l <= j.deadline_s)
        return SimResult(
            policy=self.policy.name,
            slo_attainment=float(np.mean(slo_ok)) if slo_ok else 0.0,
            mean_latency_s=float(np.mean(lat)) if lat else float("inf"),
            interactive_queue_delay_s=(float(np.mean(int_delays))
                                       if int_delays else 0.0),
            p95_latency_s=float(np.percentile(lat, 95)) if lat else float("inf"),
            finished_jobs=len(self.job_finish),
            cold_starts=self.cold_starts,
            preemptions=self.preemptions)
