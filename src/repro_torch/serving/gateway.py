"""Cross-cluster serving gateway: the LIVE plane of the Maestro hierarchy.

``ClusterGateway`` owns a fleet of real ``NodeRuntime`` engines spread over
simulated-RTT clusters and serves multi-stage workflow DAGs end-to-end
through the paper's full pipeline:

  global priority queue ordered by the POLICY (unified registry in
  ``repro_torch.core.sched.policies`` — the same objects that drive the trace
  simulator) with boundary preemption
    -> policy routing over live NodeSignals (Eq. 5-6, Alg. 3)
    -> rho-margin admission against each node's MemoryAccountant (§III.C),
       eviction-aware: Alg. 2 degradation plans enter feasibility AND are
       executed (``NodeRuntime.make_room``) at submit time
    -> real continuous-batching execution on the node engines
    -> post-execution calibration back through ``policy.on_finish``.

The gateway is the live :class:`~repro_torch.core.sched.substrate.Substrate`
implementation: it owns the queue mechanics, the clock and the telemetry,
while every scheduling decision (queue order, reservation, routing,
preemption) is delegated to the policy. Any registered policy name (fcfs /
least-loaded / edf / oracle-srtf / maestro / maestro-np / baseline-lb /
binpack / maestro-aff) runs on real engines.

The event loop is CLOCK-DRIVEN (:mod:`repro_torch.serving.clock`): network RTT
and cold-start activation enter as delayed event releases on the gateway's
clock, periodic work (aging refresh, telemetry sampling) runs on
clock-owned cadences, and the run deadline (``GatewayConfig.max_run_s``)
is enforced by the clock with a typed ``RunDeadlineExceeded`` outcome.

Two clocks plug in:

- ``clock="virtual"`` (default): one loop pass advances ``tick_s`` virtual
  seconds and runs one lock-step iteration of every busy engine. Fully
  deterministic and bit-identical to the pre-clock-plane gateway on both
  node backends — no wall-clock sleeps anywhere.
- ``clock="wall"``: real monotonic time. Process-backend workers FREE-RUN
  (continuous stepping in their own processes); the gateway submits and
  polls asynchronously, so engine iterations genuinely overlap across
  processes in measured time. Queue delay and SLO attainment come out in
  real elapsed seconds; the policies' cost estimates (``t_exec_est``,
  deadline profiling) remain the nominal virtual model, so scheduling
  decisions share one code path on both clocks.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.control_loop import model_name
from repro_torch.core.sched.fitness import NodeSignal
from repro_torch.core.sched.policies import SchedPolicy, make_policy
from repro_torch.core.sched.substrate import SchedStage
from repro_torch.core.topology import validate_rtt
from repro_torch.distributed.fault import StragglerDetector
from repro_torch.serving.clock import (RunDeadlineExceeded, VirtualClock,
                                 make_clock)
from repro_torch.serving.cluster import LiveJob, LiveStage
from repro_torch.serving.engine import PromptTooLongError, Request
from repro_torch.serving.node_runtime import NodeRuntime
from repro_torch.serving.prefix_cache import page_digests
from repro_torch.serving.registry import FleetRegistry, HeartbeatConfig
from repro_torch.serving.telemetry import (GatewayMetrics, NodeDeathEvent,
                                     Telemetry)
from repro_torch.serving.worker import WorkerDied, close_fleet

COLD_START_THRESHOLD_S = 0.01


@dataclasses.dataclass
class GatewayConfig:
    tick_s: float = 0.05              # virtual seconds per engine iteration
    interactive_budget_s: float = 1.5  # per-job interactive wait SLO
    slo_factor: float = 3.0            # batch deadline = factor * isolated
    static_reserve_tokens: int = 64    # non-predictive KV reservation (fcfs/ll)
    max_inflight_per_node: Optional[int] = None   # default: node max_slots
    reject_limit: int = 1000           # routing failures before job drop
    headroom_sample_every: int = 10    # telemetry cadence, in ticks
    # ---- clock plane ----------------------------------------------------
    # "virtual": deterministic tick clock (default — tests and all cross-PR
    # BENCH baselines). "wall": real monotonic seconds; workers free-run.
    clock: str = "virtual"
    # Run deadline in CLOCK seconds, enforced by the Clock; when exceeded
    # the metrics carry a typed RunDeadlineExceeded outcome. None = the
    # legacy workload-derived safety cap on the virtual clock, no deadline
    # on the wall clock (wall runs should set this explicitly).
    max_run_s: Optional[float] = None
    # Clock-independent policy hysteresis / cadence, in SECONDS (the
    # canonical fields — both clocks and both planes share this code path).
    # None = derived from the deprecated tick-denominated shims below.
    preempt_gain_s: Optional[float] = None     # default 2 ticks = 0.1 s
    preempt_cooldown_s: Optional[float] = None  # default 10 ticks = 0.5 s
    refresh_every_s: Optional[float] = None     # default 8 ticks = 0.4 s
    wall_poll_s: float = 0.002         # wall clock: sleep while awaiting work
    # ---- DEPRECATED tick-denominated shims ------------------------------
    # superseded by the *_s fields above; still honored (converted via
    # tick_s) so existing configs keep working, with a DeprecationWarning
    # when explicitly overridden.
    preempt_gain_ticks: float = 2.0
    preempt_cooldown_ticks: float = 10.0
    refresh_every: int = 8
    # "inproc": nodes are NodeRuntime objects cooperatively stepped inside
    # the gateway process (deterministic default — tests and the virtual
    # clock depend on it). "process": nodes are worker.NodeHandle proxies,
    # one OS process per node; under the virtual clock one tick broadcasts
    # step to every worker, under the wall clock workers free-run.
    # "socket": the same worker protocol over the framed TCP transport
    # (repro_torch.serving.transport) — localhost children by default, or remote
    # hosts via `python -m repro_torch.serving.worker --listen`; protocol-
    # identical to "process", so virtual-clock runs stay bit-identical.
    node_backend: str = "inproc"
    # ---- membership plane (transport backends, wall clock only) ---------
    # Heartbeat sweep cadence plus the liveness timeouts that demote a
    # silent worker healthy -> suspect -> dead (gateway-clock seconds).
    # Liveness is wall-clock-only: virtual time advances while workers
    # compute in real time, so a virtual-denominated deadline would kill
    # healthy nodes and break the bit-identical parity contract; under the
    # virtual clock the only death signal is transport EOF.
    heartbeat_s: float = 0.25
    suspect_after_s: float = 1.0
    dead_after_s: float = 5.0

    def resolved_seconds(self) -> Tuple[float, float, float]:
        """(preempt_gain_s, preempt_cooldown_s, refresh_every_s) with the
        deprecation shims applied: seconds-denominated fields win; tick
        fields are converted through tick_s and warn when overridden."""
        defaults = (("preempt_gain_ticks", 2.0, "preempt_gain_s"),
                    ("preempt_cooldown_ticks", 10.0, "preempt_cooldown_s"),
                    ("refresh_every", 8, "refresh_every_s"))
        for old, dflt, new in defaults:
            if getattr(self, old) != dflt and getattr(self, new) is None:
                warnings.warn(
                    f"GatewayConfig.{old} is deprecated (tick-denominated); "
                    f"set {new} in seconds instead", DeprecationWarning,
                    stacklevel=3)
        gain = (self.preempt_gain_s if self.preempt_gain_s is not None
                else self.preempt_gain_ticks * self.tick_s)
        cool = (self.preempt_cooldown_s
                if self.preempt_cooldown_s is not None
                else self.preempt_cooldown_ticks * self.tick_s)
        refresh = (self.refresh_every_s if self.refresh_every_s is not None
                   else self.refresh_every * self.tick_s)
        return float(gain), float(cool), float(refresh)


@dataclasses.dataclass
class _InFlight:
    stage: LiveStage
    node_id: int
    model: str
    req: Request
    r_need: float                     # reserved KV bytes (make_room target)
    submit_at: float                  # clock time the engine may see it
    submitted: bool = False


class ClusterGateway:
    """The LIVE-plane Substrate: pluggable clock, real engine execution."""

    def __init__(self, fleet: Sequence[NodeRuntime], rtt_s: np.ndarray,
                 predictor=None, policy: Union[str, SchedPolicy] = "maestro",
                 cfg: Optional[GatewayConfig] = None,
                 telemetry: Optional[Telemetry] = None):
        self.cfg = cfg or GatewayConfig()
        if self.cfg.node_backend not in ("inproc", "process", "socket"):
            raise ValueError(f"unknown node_backend "
                             f"{self.cfg.node_backend!r}")
        # clock plane: the event machinery (delayed RTT/T_act releases,
        # periodic cadences, run deadline) lives in the Clock — built
        # first so an invalid mode fails before any fleet state is touched
        self.clock = make_clock(self.cfg.clock, self.cfg.tick_s)
        # a fleet of worker handles implies a worker backend even when the
        # config was left at its default (the handle knows whether it is
        # process- or socket-connected); the reverse mismatch is a hard
        # error (an in-process runtime cannot be stepped remotely)
        is_worker_fleet = bool(fleet) and all(hasattr(n, "step_send")
                                              for n in fleet)
        if self.cfg.node_backend in ("process", "socket") \
                and not is_worker_fleet:
            raise ValueError(
                f"node_backend={self.cfg.node_backend!r} requires worker "
                f"NodeHandles — build the fleet with build_fleet(spec, "
                f"backend={self.cfg.node_backend!r}); 'process' and "
                f"'socket' fleets cannot be in-process runtimes")
        self.node_backend = (
            getattr(next(iter(fleet)), "backend", "process")
            if is_worker_fleet else self.cfg.node_backend)
        self.fleet: Dict[int, NodeRuntime] = {n.node_id: n for n in fleet}
        self.rtt_s = validate_rtt(rtt_s)
        # pristine copy for restore_link after fault-injected degradation
        self._nominal_rtt = self.rtt_s.copy()
        self.profiles = {name: p
                         for name, p in next(iter(self.fleet.values()))
                         .profiles.items()}
        self.telemetry = telemetry or Telemetry()
        (self.preempt_gain_s, self.preempt_cooldown_s,
         refresh_every_s) = self.cfg.resolved_seconds()
        self.policy = (make_policy(policy, predictor=predictor)
                       if isinstance(policy, str) else policy)

        self._refresh_cad = self.clock.cadence(refresh_every_s)
        self._headroom_cad = self.clock.cadence(
            self.cfg.headroom_sample_every * self.cfg.tick_s)
        self._deadline_hit: Optional[RunDeadlineExceeded] = None
        # wall-clock accounting: real busy seconds per node (in-process
        # backend; worker processes report their own step wall)
        self._node_busy_s: Dict[int, float] = {nid: 0.0 for nid in self.fleet}
        self._run_wall0: Optional[float] = None
        if self.clock.name == "wall" and self.node_backend != "inproc":
            # workers free-run: continuous stepping inside each child, the
            # gateway polls for finished requests instead of lock-stepping
            for node in self.fleet.values():
                node.set_continuous(True)

        # membership plane: the registry tracks liveness for every backend
        # (so register/retire/death events are uniformly visible), but the
        # timeout sweep + idle pings run ONLY under wall clock + worker
        # backends — heartbeats in virtual seconds would be meaningless and
        # extra pings would break the bit-identical parity contract. Under
        # the virtual clock death is detected by transport EOF alone.
        self.registry = FleetRegistry(
            HeartbeatConfig(interval_s=self.cfg.heartbeat_s,
                            suspect_after_s=self.cfg.suspect_after_s,
                            dead_after_s=self.cfg.dead_after_s),
            detector=StragglerDetector())
        for nid in self.fleet:
            self.registry.register(nid, self.clock.now())
        self._liveness_on = (self.clock.name == "wall"
                             and self.node_backend != "inproc")
        self._hb_cad = (self.clock.cadence(self.cfg.heartbeat_s)
                        if self._liveness_on else None)
        # piggybacked-heartbeat bookkeeping: a node whose reply counter
        # advanced since the last sweep was provably alive (every consumed
        # reply is a beat) — only silent nodes get an explicit ping
        self._last_traffic: Dict[int, int] = {
            nid: getattr(n, "ipc_calls", 0)
            for nid, n in self.fleet.items()}
        self._last_busy: Dict[int, float] = {nid: 0.0 for nid in self.fleet}
        self._last_sweep_t: Optional[float] = None
        self._requeued_stages = 0
        # dead/retired handles kept for end-of-run counter harvesting +
        # close(); their node ids have already left self.fleet
        self._gone_handles: List = []

        # workload state
        self.stage_by_id: Dict[int, LiveStage] = {}
        self.jobs: Dict[int, LiveJob] = {}
        self.pending_deps: Dict[int, int] = {}
        self.ready_t: Dict[int, float] = {}
        self.done: set = set()
        self.job_done_stages: Dict[int, int] = {}
        self.job_finish: Dict[int, float] = {}
        self.dropped: set = set()
        self.arrivals: List[Tuple[float, int]] = []   # (arrival_s, job_id)
        self.inflight: Dict[int, _InFlight] = {}      # stage_id -> record
        self.node_load: Dict[int, int] = {nid: 0 for nid in self.fleet}
        self.inflight_cap: Dict[int, int] = {
            nid: (self.cfg.max_inflight_per_node
                  or self.fleet[nid].max_slots)
            for nid in self.fleet}
        self.qd_ewma: Dict[int, float] = {nid: 0.0 for nid in self.fleet}
        # KV reserved by dispatched-but-not-yet-submitted stages: charged at
        # dispatch so admission cannot hand the same headroom to two stages
        # during the rtt + t_act transit window, released when the engine's
        # own accounting takes over at submit
        self.pending_resv: Dict[int, float] = {nid: 0.0 for nid in self.fleet}
        # largest prompt ANY node's engine window accepts (>=1 decode slot);
        # per-node windows can be smaller — the engine's typed
        # PromptTooLongError in _submit_inflight stays as the backstop
        self._max_prompt = max(n.s_max for n in self.fleet.values()) - 1
        self._truncated = 0
        self._rejects: Dict[int, int] = collections.defaultdict(int)
        self._views: Dict[int, SchedStage] = {}
        # prefix-affinity routing inputs: chained page digests of each
        # stage's prompt, computed lazily per stage and memoized (the page
        # geometry is fleet-uniform — every node shares one arena layout)
        self._page_tokens = next(iter(self.fleet.values())).page_tokens
        self._stage_digests: Dict[int, Tuple[str, ...]] = {}

        # the global queue: (priority, seq, stage_id) heap + live-id set;
        # priorities come from policy.priority and are refreshed on the
        # aging cadence (stale in between, exactly like the sim's heap)
        self._q: List[Tuple[float, int, int]] = []
        self._queued: set = set()
        self._qseq = 0
        self.policy.setup(self)

    # ----------------------------------------------------------------- views
    @property
    def now(self) -> float:
        return self.clock.now()

    @property
    def tick(self) -> int:
        """Tick counter of the virtual clock (legacy introspection); on the
        wall clock, the nominal tick index real time corresponds to."""
        if isinstance(self.clock, VirtualClock):
            return self.clock.tick
        return int(self.clock.now() / self.cfg.tick_s)

    @property
    def ctl(self):
        """The policy's MaestroController when it has one (calibration
        introspection for examples/benchmarks); None for baselines."""
        return getattr(self.policy, "ctl", None)

    def model_of(self, stage: LiveStage) -> str:
        return model_name(stage.obs, self.profiles)

    def rtt(self, stage: LiveStage, nid: int) -> float:
        src = stage.obs.src_cluster % self.rtt_s.shape[0]
        return float(self.rtt_s[src, self.fleet[nid].cluster_id])

    def view(self, stage: LiveStage) -> SchedStage:
        v = self._views.get(stage.stage_id)
        if v is None:
            job = self.jobs[stage.job_id]
            v = SchedStage(stage_id=stage.stage_id, job_id=stage.job_id,
                           model=self.model_of(stage),
                           interactive=stage.interactive,
                           prompt_len=stage.obs.prompt_len,
                           arrival_s=job.arrival_s,
                           deadline_s=job.deadline_s, obs=stage.obs)
            self._views[stage.stage_id] = v
        return v

    # --------------------------------------------------- Substrate protocol
    def node_ids(self) -> Sequence[int]:
        return sorted(self.fleet)

    def _reported_signal(self, nid: int) -> Optional[NodeSignal]:
        """Wall clock + free-running workers: the boundary-fresh NodeSignal
        the child piggybacked on its last poll reply (§III's periodic
        node->scheduler report). Routing/admission against this report
        costs no round trip — a synchronous query would block until the
        child's next engine-step boundary, stalling the dispatch loop.
        None outside that mode (or before the first poll), meaning: ask
        the node synchronously."""
        if self.clock.name == "wall" and self.node_backend != "inproc":
            return self.fleet[nid].last_signal()
        return None

    def signal(self, nid: int) -> NodeSignal:
        """Live NodeSignal with the gateway's clock-based queue-delay EWMA
        (the runtime's own queue statistic is engine-local, not seconds)."""
        sig = self._reported_signal(nid)
        sig = (dataclasses.replace(sig) if sig is not None
               else self.fleet[nid].signal())
        sig.queue_delay_s = self.qd_ewma[nid]
        return sig

    def load(self, nid: int) -> int:
        return self.node_load[nid]

    def can_admit(self, nid: int, r_need: float,
                  model: Optional[str] = None) -> bool:
        if self.node_load[nid] >= self.inflight_cap[nid]:
            return False
        sig = self._reported_signal(nid)
        if sig is not None:
            # signal-based admission: charge un-warm models their weight +
            # context against the REPORTED headroom. Conservative relative
            # to the node's own eviction-aware check (reclaimable-by-
            # degradation memory is not counted); the engine's waiting
            # queue + make_room at submit remain the ground-truth backstop.
            extra = 0.0
            if model is not None and model not in sig.warm_models:
                prof = self.profiles[model]
                extra = prof.weight_bytes + prof.ctx_bytes
            return (sig.headroom - self.pending_resv[nid]
                    >= r_need + extra)
        return self.fleet[nid].can_admit(
            r_need + self.pending_resv[nid], model)

    def t_act(self, nid: int, model: str) -> float:
        sig = self._reported_signal(nid)
        if sig is not None:
            if model in sig.warm_models:
                return sig.warm_models[model]
            # cold model on a free-running worker: estimate the host->device
            # transfer from the profile instead of a blocking round trip
            # (a sync query would stall dispatch until the child's next
            # engine-step boundary; routing only needs the ranking signal)
            prof = self.profiles[model]
            return prof.weight_bytes / prof.hw.host_link_bw
        return self.fleet[nid].t_act(model)

    def degradation_cost(self, nid: int, r_need: float) -> Optional[float]:
        sig = self._reported_signal(nid)
        if sig is not None and sig.headroom >= r_need:
            # no shortfall against the reported headroom: C_deg is 0 by
            # definition (NodeRuntime's own shortfall<=0 fast path) — skip
            # the blocking round trip. A genuine shortfall still asks the
            # node (it needs the engines' in-flight state for Alg. 2).
            return 0.0
        return self.fleet[nid].degradation_cost(r_need)

    def known_stages(self) -> List[SchedStage]:
        return []                     # stages arrive online

    def static_reservation(self, stage: SchedStage) -> float:
        prof = self.profiles[stage.model]
        return prof.r_kv(len(self.stage_by_id[stage.stage_id].tokens),
                         self.cfg.static_reserve_tokens)

    def t_exec_est(self, stage: SchedStage,
                   l_hat: Optional[float]) -> float:
        """Stage duration under the NOMINAL virtual execution model (prefill
        tick + one decode tick per predicted token, capped by the decode
        budget). Used by policies on BOTH clocks — wall-mode scheduling
        ranks by the same estimates, so decisions share one code path."""
        ls = self.stage_by_id[stage.stage_id]
        l_hat = ls.max_new if l_hat is None else min(l_hat, ls.max_new)
        return self.cfg.tick_s * (1.0 + l_hat)

    def true_remaining_s(self, stage: SchedStage) -> float:
        job = self.jobs[stage.job_id]
        return sum(self.cfg.tick_s * (1.0 + s.max_new) for s in job.stages
                   if s.stage_id not in self.done)

    def ready_since(self, stage_id: int) -> float:
        return self.ready_t.get(stage_id, float("inf"))

    def prefix_digests(self, stage: SchedStage) -> Sequence[str]:
        """Chained prefix-page digests of the stage's live prompt, for
        prefix-affinity routing (the same chain the node engines index)."""
        d = self._stage_digests.get(stage.stage_id)
        if d is None:
            ls = self.stage_by_id[stage.stage_id]
            d = tuple(page_digests(ls.tokens, self._page_tokens,
                                   stage.model))
            self._stage_digests[stage.stage_id] = d
        return d

    def job_remaining_v(self, stage: LiveStage) -> float:
        """Remaining nominal execution time of the stage's job, AFTER this
        stage — the Eq. 8 sample recorded into the WorkflowProfileStore."""
        job = self.jobs[stage.job_id]
        return sum(self.cfg.tick_s * (1.0 + s.max_new) for s in job.stages
                   if s.stage_id not in self.done
                   and s.stage_id != stage.stage_id)

    # -------------------------------------------------------- global queue
    def _q_push(self, stage: LiveStage, now: float) -> None:
        self._qseq += 1
        pri = self.policy.priority(self, self.view(stage), now)
        heapq.heappush(self._q, (pri, self._qseq, stage.stage_id))
        self._queued.add(stage.stage_id)

    def _q_peek(self, now: float) -> Optional[LiveStage]:
        while self._q:
            _, _, sid = self._q[0]
            if sid not in self._queued:
                heapq.heappop(self._q)     # stale entry
                continue
            return self.stage_by_id[sid]
        return None

    def _q_pop(self, now: float) -> Optional[LiveStage]:
        stage = self._q_peek(now)
        if stage is not None:
            heapq.heappop(self._q)
            self._queued.discard(stage.stage_id)
        return stage

    def _q_discard(self, stage_id: int) -> None:
        self._queued.discard(stage_id)

    def _q_refresh(self, now: float) -> None:
        """Recompute (aged) priorities — heap entries are stale otherwise."""
        live = list(self._queued)
        self._q.clear()
        self._queued.clear()
        for sid in live:
            self._q_push(self.stage_by_id[sid], now)

    # ------------------------------------------------------------- workload
    def submit_jobs(self, jobs: Sequence[LiveJob]) -> None:
        for j in jobs:
            self.jobs[j.job_id] = j
            self.job_done_stages.setdefault(j.job_id, 0)
            if j.deadline_s <= 0.0:
                j.deadline_s = self._deadline(j)
            self.arrivals.append((j.arrival_s, j.job_id))
            for s in j.stages:
                self.stage_by_id[s.stage_id] = s
                self.pending_deps[s.stage_id] = len(s.deps)
        self.arrivals.sort()

    def _deadline(self, job: LiveJob) -> float:
        """SLO profiling against the nominal virtual execution model:
        critical-path time with everything warm, scaled by slo_factor.
        (Wall-clock runs keep these nominal deadlines — batch SLO rows are
        machine-dependent there; see docs/BENCHMARKS.md.)"""
        finish: Dict[int, float] = {}
        for s in job.stages:
            start = max((finish[d] for d in s.deps), default=0.0)
            finish[s.stage_id] = start + self.cfg.tick_s * (2.0 + s.max_new)
        return self.cfg.slo_factor * max(finish.values())

    # ------------------------------------------------------------ event loop
    def _auto_deadline_s(self, jobs: Sequence[LiveJob]) -> float:
        """Workload-derived safety cap (the legacy ``max_ticks`` heuristic,
        now expressed in seconds and enforced by the Clock with a typed
        outcome instead of silent truncation)."""
        n_stage_ticks = sum(s.max_new + 6 for j in jobs for s in j.stages)
        return (40 * n_stage_ticks + 4000) * self.cfg.tick_s

    def run(self, jobs: Sequence[LiveJob],
            max_ticks: Optional[int] = None,
            max_run_s: Optional[float] = None,
            fault_plan=None) -> GatewayMetrics:
        """Serve ``jobs`` to completion or until the run deadline.

        The deadline comes from (first match wins) the deprecated
        ``max_ticks`` argument (virtual ticks), the ``max_run_s`` argument,
        ``GatewayConfig.max_run_s``, or — virtual clock only — the
        workload-derived safety cap. A deadline that fires is reported as a
        typed ``RunDeadlineExceeded`` in the returned metrics.

        ``fault_plan`` (a ``repro_torch.serving.faultplan.FaultPlan``, duck-typed
        via its ``arm``) schedules mid-run events — worker kills, link
        degradation, replacement nodes — on this gateway's clock; arming
        happens after the clock restart so event times are run-relative."""
        self.submit_jobs(jobs)
        self._run_wall0 = time.perf_counter()
        # serving time starts NOW: pre-run work (e.g. warmup) is not billed
        # to the measured window (no-op on the virtual clock)
        self.clock.restart()
        if fault_plan is not None:
            fault_plan.arm(self)
        if max_run_s is None:
            max_run_s = self.cfg.max_run_s
        if max_ticks is not None:
            if isinstance(self.clock, VirtualClock):
                self.clock.set_deadline_ticks(max_ticks)  # exact legacy cap
            else:
                self.clock.set_deadline(max_ticks * self.cfg.tick_s)
        elif max_run_s is not None:
            self.clock.set_deadline(max_run_s)
        elif isinstance(self.clock, VirtualClock):
            self.clock.set_deadline(self._auto_deadline_s(jobs))
        # wall clock with no explicit cap: unbounded (machine speed unknown)
        while self._unfinished() and not self.clock.expired():
            self.step()
        if self._unfinished() and self.clock.expired():
            self._deadline_hit = RunDeadlineExceeded(
                max_run_s=float(self.clock.deadline_s),
                elapsed_s=self.clock.now(),
                unfinished_jobs=sum(1 for j in self.jobs
                                    if j not in self.job_finish
                                    and j not in self.dropped))
        return self.metrics()

    def _unfinished(self) -> bool:
        return any(j not in self.job_finish and j not in self.dropped
                   for j in self.jobs)

    def metrics(self) -> GatewayMetrics:
        m = self.telemetry.summary(
            self.policy.name, list(self.jobs.values()), self.job_finish,
            self.cfg.interactive_budget_s, self.now)
        # physical paged-KV arena: worst-node overcommit + fleet peaks —
        # kv_stats() is one round trip per node on the process backend
        stats = [n.kv_stats() for n in self.fleet.values()]
        m.kv_overcommit_ratio = max(
            (s["kv_overcommit_ratio"] for s in stats if s["n_engines"]),
            default=0.0)
        m.arena_peak_pages = sum(s["arena_peak_pages"] for s in stats)
        m.arena_utilization = max(
            (s["arena_utilization"] for s in stats), default=0.0)
        # prefix-cache plane: fleet-summed index counters (plus the arena's
        # alias/COW totals) — empty keys stay absent when no node enabled it
        pkeys = sorted({k for s in stats for k in s
                        if k.startswith("prefix_")})
        if pkeys:
            m.prefix_stats = {k: float(sum(s.get(k, 0) for s in stats))
                              for k in pkeys}
            for k in ("pages_aliased", "cow_copies"):
                m.prefix_stats[k] = float(sum(s.get(k, 0) for s in stats))
        # engine iteration-scheduler counters, summed fleet-wide (older
        # kv_stats snapshots may lack them — remote workers predate the keys)
        for k in ("engine_prefill_tokens", "engine_decode_tokens",
                  "engine_prefill_compiles", "engine_fused_steps",
                  "engine_steps", "engine_horizon_steps",
                  "engine_decode_syncs"):
            setattr(m, k, int(sum(s.get(k, 0) for s in stats)))
        # decode-horizon headline: host round-trips per emitted decode token
        m.host_syncs_per_token = (m.engine_decode_syncs
                                  / max(m.engine_decode_tokens, 1))
        m.truncated_stages = self._truncated
        m.node_backend = self.node_backend
        m.clock = self.clock.name
        if self._deadline_hit is not None:
            m.run_outcome = "deadline_exceeded"
            m.run_deadline = self._deadline_hit
        if self.node_backend != "inproc":
            # dead/retired handles first so a replacement that re-used a
            # node id overwrites them with the live handle's counters
            for node in self._gone_handles:
                self.telemetry.record_worker(node.node_id,
                                             node.worker_stats())
            for nid, node in self.fleet.items():
                self.telemetry.record_worker(nid, node.worker_stats())
            m.worker_stats = dict(self.telemetry.worker_stats)
            m.ipc_calls = sum(int(w["ipc_calls"])
                              for w in m.worker_stats.values())
            m.ipc_wall_s = sum(w["ipc_wall_s"]
                               for w in m.worker_stats.values())
            m.worker_step_wall_s = sum(w["worker_step_wall_s"]
                                       for w in m.worker_stats.values())
            m.heartbeat_misses = sum(
                int(w.get("heartbeat_misses", 0))
                for w in m.worker_stats.values())
            # socket transport overhead (zero on the pipe backends)
            m.rpc_bytes_sent = sum(int(w.get("bytes_sent", 0))
                                   for w in m.worker_stats.values())
            m.rpc_bytes_recv = sum(int(w.get("bytes_recv", 0))
                                   for w in m.worker_stats.values())
        # membership plane: deaths/evacuations and end-of-run liveness.
        # Identical across backends under the virtual clock (no deaths, all
        # healthy) so the parity contract holds; straggler flags are wall-
        # only because the observations are real seconds.
        m.node_deaths = len(self.telemetry.node_deaths)
        m.death_events = list(self.telemetry.node_deaths)
        m.requeued_stages = self._requeued_stages
        m.liveness = self.registry.states()
        if self.clock.name == "wall":
            m.straggler_nodes = self.registry.stragglers()
            # wall-only telemetry (left zero/empty on the virtual clock so
            # virtual metrics stay bit-identical across backends):
            # makespan in real seconds, per-node busy fractions and the
            # fleet overlap factor (sum of busy seconds / makespan; > 1
            # means engine compute genuinely overlapped across nodes)
            m.wall_makespan_s = m.makespan_s
            busy = (dict(self._node_busy_s)
                    if self.node_backend == "inproc" else
                    {nid: node.worker_stats()["worker_step_wall_s"]
                     for nid, node in self.fleet.items()})
            span = max(m.makespan_s, 1e-9)
            m.node_busy_frac = {nid: b / span for nid, b in busy.items()}
            m.overlap_factor = sum(busy.values()) / span
        return m

    def close(self) -> None:
        """Shut worker processes down (no-op for the in-process backend),
        including handles already dead or retired mid-run."""
        close_fleet(list(self.fleet.values()) + self._gone_handles)

    def warmup(self) -> None:
        """Pre-activate every model on every node by running one tiny
        request through each engine (prefill + decode), so weight transfer,
        JIT compilation and first-touch allocation happen BEFORE the
        measured serving window — the standard deployment warmup. On the
        worker-process fleet children warm up in parallel. Not called by
        default: virtual-clock baselines and tests measure cold fleets;
        the wall-clock benchmark calls it so makespan compares steady-state
        serving rather than per-process compile time."""
        for nid, node in self.fleet.items():
            for k, model in enumerate(sorted(self.profiles)):
                node.submit(model, Request(req_id=-(nid * 64 + k + 1),
                                           tokens=[1, 2, 3], max_new=2))
        free_running = (self.clock.name == "wall"
                        and self.node_backend != "inproc")
        for _ in range(512):                    # bounded drain
            if not any(n.has_work() for n in self.fleet.values()):
                break
            if free_running:
                # children already free-run: just drain their buffers
                for n in self.fleet.values():
                    n.poll_finished()
                time.sleep(0.005)
            elif self.node_backend != "inproc":
                for n in self.fleet.values():
                    n.step_send()
                for n in self.fleet.values():
                    n.step_recv()
            else:
                for n in self.fleet.values():
                    n.step()                    # warmup output discarded

    def step(self) -> None:
        now = self.clock.now()
        # 1) arrivals: source stages of newly arrived jobs become ready
        while self.arrivals and self.arrivals[0][0] <= now:
            _, jid = self.arrivals.pop(0)
            for s in self.jobs[jid].stages:
                if not s.deps:
                    self._mark_ready(s, now)
        # 2) membership sweep (wall clock + worker backends only): fold
        # piggybacked heartbeats, ping silent nodes, age the liveness state
        # machine, evacuate timeouts
        if self._liveness_on and self._hb_cad.due():
            self._membership_sweep(now)
        # 3) aging refresh of the global queue (clock-owned cadence)
        if self._refresh_cad.due():
            self._q_refresh(now)
        # 4) global-queue dispatch (routing + admission + preemption); a
        # worker dying mid-decision surfaces typed and is evacuated here
        try:
            self._dispatch(now)
        except WorkerDied as e:
            self._on_node_death(e.node_id, now, cause=str(e))
        # 5) transit releases: stages whose rtt + activation delay elapsed
        # (scheduled as clock events at dispatch) hit their engines
        self._fire_releases(now)
        # 6) engine progress: lock-step under the virtual clock, polling of
        # free-running workers / direct stepping under the wall clock
        did_work = self._collect_finished(now)
        # 7) telemetry sampling (reported signals when workers free-run —
        # an accountant round trip would block on an engine-step boundary)
        if self._headroom_cad.due():
            for nid, node in list(self.fleet.items()):
                try:
                    sig = self._reported_signal(nid)
                    self.telemetry.sample_headroom(
                        nid, sig.headroom if sig is not None
                        else node.acc.headroom)
                except WorkerDied as e:
                    self._on_node_death(e.node_id, now, cause=str(e))
        # 8) advance time: one tick (virtual) or sleep until the next
        # wake-up (wall; skipped when engines did real work this pass)
        self.clock.advance(None if did_work else self._next_wake(now))

    def _collect_finished(self, now: float) -> bool:
        """Drive engine progress and drain finished requests; returns True
        when real engine work happened this pass (wall-clock pacing)."""
        if self.clock.name != "wall":
            # virtual: one lock-step iteration of every busy engine. Process
            # backend: broadcast the step to all workers first so node
            # iterations run concurrently, then collect replies in node
            # order — same per-node event order as the cooperative
            # in-process loop, so the virtual-clock outcome is identical
            # (tests/test_worker.py parity)
            if self.node_backend != "inproc":
                for node in list(self.fleet.values()):
                    try:
                        node.step_send()
                    except WorkerDied as e:
                        self._on_node_death(e.node_id, now, cause=str(e))
            for nid, node in list(self.fleet.items()):
                if nid not in self.fleet:      # died earlier this pass
                    continue
                try:
                    out = (node.step_recv()
                           if self.node_backend != "inproc"
                           else node.step())
                except WorkerDied as e:
                    self._on_node_death(e.node_id, now, cause=str(e))
                    continue
                self._drain(out, now)
            return True
        if self.node_backend != "inproc":
            # workers free-run with one poll outstanding per busy node; the
            # gateway folds in whatever replies are already in the pipe
            # (a child answers at its next engine-step boundary), then
            # re-arms — the dispatch loop NEVER blocks on worker compute,
            # so finished stages turn into new dispatches within ~wall_poll_s
            for nid, node in list(self.fleet.items()):
                try:
                    out = node.drain_ready()
                    if out:
                        self._drain(out, self.clock.now())
                    for rid in node.take_submit_errors():
                        # async submit rejected (typed prompt-too-long): the
                        # stage finishes truncated, same as the sync path
                        rec = self.inflight.get(rid)
                        if rec is not None:
                            rec.req.truncated = True
                            self._truncated += 1
                            self._on_finish(rec.req, self.clock.now())
                    node.poll_send()
                except WorkerDied as e:
                    self._on_node_death(e.node_id, self.clock.now(),
                                        cause=str(e))
            return False      # polling is not compute: let advance() pace
        # wall + in-process: the gateway itself steps busy engines, one
        # node after another — real elapsed time, but serialized in this
        # process (the measured contrast to the free-running worker fleet)
        stepped = False
        for nid, node in self.fleet.items():
            if node.has_work():
                t0 = time.perf_counter()
                out = node.step()
                self._node_busy_s[nid] += time.perf_counter() - t0
                stepped = True
                self._drain(out, self.clock.now())
        return stepped

    def _drain(self, out: Dict[str, List[Request]], now: float) -> None:
        for model, reqs in out.items():
            for req in reqs:
                self._on_finish(req, now)

    def _next_wake(self, now: float) -> float:
        """Earliest clock time anything can change (wall-clock sleep hint):
        the next arrival, the next transit release, or a short poll
        interval while work is queued or in flight."""
        cands = []
        if self.arrivals:
            cands.append(self.arrivals[0][0])
        nxt = self.clock.peek_next()
        if nxt is not None:
            cands.append(nxt)
        if self.inflight or self._queued:
            cands.append(now + self.cfg.wall_poll_s)
        if not cands:
            return now + self.cfg.wall_poll_s
        return min(cands)

    # -------------------------------------------------------------- phases
    def _mark_ready(self, stage: LiveStage, now: float) -> None:
        if stage.job_id in self.dropped:
            return
        self.ready_t[stage.stage_id] = now
        ev = self.telemetry.event(stage.stage_id, stage.job_id,
                                  stage.interactive)
        ev.ready_t = now
        ev.model = self.model_of(stage)
        self._q_push(stage, now)

    def _dispatch(self, now: float) -> None:
        while self._queued:
            stage = self._q_peek(now)
            if stage is None:
                break
            if stage.job_id in self.dropped or stage.stage_id in self.done:
                self._q_pop(now)
                continue
            if len(stage.tokens) > self._max_prompt:
                # no engine window in the fleet can hold this prompt: finish
                # it truncated HERE, before it costs a dispatch, transit
                # delay, cold start or make_room eviction it can never use
                self._q_pop(now)
                self._truncated += 1
                req = Request(req_id=stage.stage_id,
                              tokens=list(stage.tokens),
                              max_new=stage.max_new, truncated=True)
                self._complete(stage, self.model_of(stage), req, now)
                continue
            view = self.view(stage)
            r_need = self.policy.reservation(self, view)
            nid = self.policy.route(self, view, r_need)
            if nid is None:
                # memory infeasibility (a node had a free slot yet could not
                # admit) is an ADMISSION rejection; all-slots-busy is plain
                # queueing and neither counted nor held against the job
                slots_free = any(self.node_load[n] < self.inflight_cap[n]
                                 for n in self.fleet)
                if slots_free:
                    self.telemetry.admission_rejections += 1
                    self.telemetry.event(stage.stage_id, stage.job_id,
                                         stage.interactive).rejections += 1
                    self._rejects[stage.stage_id] += 1
                if (self.policy.requeue_at_boundary and stage.interactive
                        and self._try_preempt(stage, now)):
                    continue                   # retry the head post-eviction
                if self._rejects[stage.stage_id] > self.cfg.reject_limit:
                    self._drop_job(stage.job_id, now)
                    continue
                break                          # head-of-line block
            self._q_pop(now)
            try:
                self._dispatch_to(stage, nid, r_need, now)
            except WorkerDied as e:
                # the chosen node died between routing and dispatch: the
                # stage is already popped, so put it straight back in the
                # queue (still not-yet-dispatched) and evacuate the node
                self._q_push(stage, now)
                self._on_node_death(e.node_id, now, cause=str(e))

    def _dispatch_to(self, stage: LiveStage, nid: int, r_need: float,
                     now: float) -> None:
        view = self.view(stage)
        model = view.model
        rtt = self.rtt(stage, nid)
        # through the Substrate method, NOT the node: under the wall clock
        # with free-running workers it answers from the reported signal (a
        # direct node query would block until an engine-step boundary)
        t_act = self.t_act(nid, model)
        if t_act > COLD_START_THRESHOLD_S:
            self.telemetry.cold_starts += 1
        l_hat = self.policy.predicted_len(self, view)
        req = Request(req_id=stage.stage_id, tokens=list(stage.tokens),
                      max_new=stage.max_new,
                      pred_len=(None if l_hat is None
                                else float(min(l_hat, stage.max_new))))
        rec = _InFlight(
            stage=stage, node_id=nid, model=model, req=req, r_need=r_need,
            submit_at=now + rtt + t_act)
        self.inflight[stage.stage_id] = rec
        # RTT + activation transit as a timed event release on the clock
        self.clock.call_at(rec.submit_at, rec)
        self.node_load[nid] += 1
        self.pending_resv[nid] += r_need
        wait = max(0.0, now - self.ready_t.get(stage.stage_id, now))
        self.qd_ewma[nid] = 0.8 * self.qd_ewma[nid] + 0.2 * (wait + t_act)
        ev = self.telemetry.event(stage.stage_id, stage.job_id,
                                  stage.interactive)
        ev.node_id, ev.dispatch_t = nid, now
        ev.rtt_s, ev.t_act_s = rtt, t_act

    def _fire_releases(self, now: float) -> None:
        """Submit every stage whose transit event released. Stale events
        (the stage was preempted or re-dispatched while in transit, so a
        different record — or none — is in flight) are dropped. Callable
        payloads (fault-plan events armed via ``clock.call_at``) run here,
        at the same clock boundary as transit releases, so injected faults
        land at deterministic virtual times."""
        for rec in self.clock.pop_due():
            if callable(rec):
                rec(now)
                continue
            if self.inflight.get(rec.stage.stage_id) is not rec \
                    or rec.submitted:
                continue
            self._submit_inflight(rec, now)

    def _submit_inflight(self, rec: _InFlight, now: float) -> None:
        try:
            self._submit_inflight_inner(rec, now)
        except WorkerDied as e:
            # node died under the submit: evacuation requeues this record
            # (and every sibling in flight there) as not-yet-dispatched
            self._on_node_death(e.node_id, now, cause=str(e))

    def _submit_inflight_inner(self, rec: _InFlight, now: float) -> None:
        node = self.fleet[rec.node_id]
        sig = self._reported_signal(rec.node_id)
        if sig is not None and sig.headroom >= rec.r_need:
            pass        # reported headroom covers it: no accountant query
        elif not node.acc.can_admit(rec.r_need):
            # Alg. 2 cheap prefix (levels 1-2) executed live: sleep idle
            # engines / drop warm contexts so the reservation fits
            node.make_room(rec.r_need)
        t0 = time.perf_counter()
        rec.submitted = True
        self.pending_resv[rec.node_id] -= rec.r_need
        if self.clock.name == "wall" and self.node_backend != "inproc":
            # free-running fleet: fire-and-forget — the ack (or typed
            # prompt-too-long, surfaced via take_submit_errors on the next
            # drain) would otherwise block the dispatch loop until the
            # child's engine-step boundary
            node.submit_send(rec.model, rec.req)
            ev = self.telemetry.event(rec.stage.stage_id, rec.stage.job_id,
                                      rec.stage.interactive)
            ev.start_t = now          # wall_act_s unknown on the async path
            return
        try:
            node.submit(rec.model, rec.req)   # real activation on demand
        except PromptTooLongError:
            # typed rejection instead of silent KV overflow: the stage
            # finishes truncated (empty output) and its job continues
            rec.req.truncated = True
            self._truncated += 1
            self._on_finish(rec.req, now)
            return
        ev = self.telemetry.event(rec.stage.stage_id, rec.stage.job_id,
                                  rec.stage.interactive)
        ev.start_t = now
        ev.wall_act_s = time.perf_counter() - t0

    def _on_finish(self, req: Request, now: float) -> None:
        rec = self.inflight.pop(req.req_id, None)
        if rec is None:
            return
        self.node_load[rec.node_id] -= 1
        self._complete(rec.stage, rec.model, req, now)

    def _complete(self, stage: LiveStage, model: str, req: Request,
                  now: float) -> None:
        self.done.add(stage.stage_id)
        self._rejects.pop(stage.stage_id, None)
        ev = self.telemetry.event(stage.stage_id, stage.job_id,
                                  stage.interactive)
        # telemetry's finished sentinel is finish_t > 0; dispatch-time
        # truncation can legitimately land at exactly t=0, so clamp
        ev.finish_t, ev.out_len = max(now, 1e-9), len(req.out)
        ev.prompt_tokens = len(req.tokens)
        ev.prefill_avoided = int(getattr(req, "prefill_avoided", 0))
        ev.ttft_s = float(getattr(req, "ttft_s", 0.0))
        # Calibrate on the SAME basis the prediction used (the uncapped
        # trace-scale lengths): the realized output, mapped back through the
        # live decode budget, against L_hat. Comparing live capped bytes to
        # the uncapped R_kv_hat would make the error identically zero and
        # pin rho to its floor.
        if not req.truncated:
            # truncated stages never ran to their true length — feeding
            # their (near-zero) realized KV into calibration would record a
            # phantom maximal overprediction and skew rho for real stages
            prof = self.profiles[model]
            nominal = stage.nominal_len or stage.max_new
            actual_len = nominal * len(req.out) / max(stage.max_new, 1)
            actual_kv = prof.r_kv(stage.obs.prompt_len, actual_len)
            self.policy.on_finish(self, self.view(stage), actual_kv,
                                  self.job_remaining_v(stage))
        job = self.jobs[stage.job_id]
        self.job_done_stages[stage.job_id] += 1
        if self.job_done_stages[stage.job_id] == len(job.stages):
            self.job_finish[stage.job_id] = now
        # successor re-queueing: every dependent whose deps are all done
        # re-enters the GLOBAL queue and contends under the policy's order
        for st in job.stages:
            if stage.stage_id in st.deps:
                self.pending_deps[st.stage_id] -= 1
                if self.pending_deps[st.stage_id] == 0:
                    self._mark_ready(st, now)

    # ---------------------------------------------------- membership plane
    def _membership_sweep(self, now: float) -> None:
        """One heartbeat pass (wall clock + worker backends only): reap
        visibly dead processes, fold piggybacked heartbeats (any reply
        consumed since the last sweep proves the worker alive), ping nodes
        that were silent, feed step-wall deltas to the straggler detector,
        and age the liveness state machine.

        Stall amnesty: if the GATEWAY itself paused longer than a sweep
        period (a replacement worker booting inside a fault-plan event, a
        long jit compile, a GC-style hiccup), worker silence over that gap
        proves nothing — the gateway wasn't listening. Nodes that still
        look alive at the transport level get a free beat before aging, so
        a local pause never wipes a healthy fleet."""
        stalled = (self._last_sweep_t is not None
                   and now - self._last_sweep_t
                   > max(self.cfg.suspect_after_s,
                         2.0 * self.cfg.heartbeat_s))
        self._last_sweep_t = now
        for nid, node in list(self.fleet.items()):
            proc = getattr(node, "proc", None)
            if proc is not None and not proc.is_alive():
                self._on_node_death(
                    nid, now,
                    cause=f"process exited (exitcode={proc.exitcode})")
                continue
            calls = getattr(node, "ipc_calls", 0)
            if calls > self._last_traffic.get(nid, 0):
                self.registry.beat(nid, now)   # replies ARE heartbeats
            elif stalled:
                self.registry.beat(nid, now)   # our pause, not its silence
            elif hasattr(node, "ping_send"):
                try:
                    node.ping_send()           # idle-period probe
                except WorkerDied as e:
                    self._on_node_death(e.node_id, now, cause=str(e))
                    continue
            self._last_traffic[nid] = calls
            busy = (node.worker_stats()["worker_step_wall_s"]
                    if hasattr(node, "worker_stats")
                    else self._node_busy_s.get(nid, 0.0))
            delta = busy - self._last_busy.get(nid, 0.0)
            if delta > 0:
                self.registry.observe_step(nid, delta)
            self._last_busy[nid] = busy
        for nid in self.registry.update(now):
            if nid in self.fleet:
                self._on_node_death(nid, now, cause="heartbeat timeout")

    def _evacuate_node(self, nid: int, now: float) -> List[int]:
        """Pull every in-flight stage off node ``nid`` and put it back in
        the ready queue as not-yet-dispatched: the aborted attempt's wait
        is banked (like preemption), per-node reservations/prefix affinity
        are written off with the node, and pending transit releases go
        stale (they are dropped by the `is rec` check in _fire_releases).
        Returns the evacuated stage ids."""
        requeued: List[int] = []
        for sid, rec in list(self.inflight.items()):
            if rec.node_id != nid:
                continue
            del self.inflight[sid]
            ev = self.telemetry.event(sid, rec.stage.job_id,
                                      rec.stage.interactive)
            ev.worker_deaths += 1
            ev.prior_wait_s += (max(0.0, ev.dispatch_t - ev.ready_t)
                                + ev.rtt_s + ev.t_act_s)
            ev.rtt_s = ev.t_act_s = 0.0
            requeued.append(sid)
            self._mark_ready(rec.stage, now)
        self._requeued_stages += len(requeued)
        for d in (self.node_load, self.inflight_cap, self.qd_ewma,
                  self.pending_resv, self._node_busy_s,
                  self._last_traffic, self._last_busy):
            d.pop(nid, None)
        return requeued

    def _on_node_death(self, nid: int, now: float,
                       cause: str = "transport failure") -> None:
        """A worker died (transport EOF, dead process, heartbeat timeout):
        remove it from the serving fleet, evacuate its in-flight stages
        back to the ready queue, and surface a typed NodeDeathEvent. The
        survivors keep serving; losing the LAST node is fatal (nothing
        could ever finish and the loop would spin forever)."""
        node = self.fleet.pop(nid, None)
        if node is None:
            return                         # already evacuated this pass
        self._gone_handles.append(node)
        self.registry.mark_dead(nid, now, cause=cause)
        requeued = self._evacuate_node(nid, now)
        self.telemetry.node_death(NodeDeathEvent(
            node_id=nid, t=now, cause=cause,
            requeued_stages=tuple(requeued)))
        close_fleet([node])                # reap the corpse, best-effort
        if not self.fleet:
            raise RuntimeError(
                f"node {nid} died ({cause}) and no nodes remain in the "
                f"fleet — cannot make progress")
        self._max_prompt = max(n.s_max for n in self.fleet.values()) - 1

    def register_node(self, node) -> int:
        """Mid-run elasticity: admit a booted node (in-process
        ``NodeRuntime`` or worker handle matching the fleet's backend) to
        the serving fleet. A dead node's id may be reused — that is the
        reconnect path: a replacement worker joining under the same id."""
        if hasattr(node, "wait_ready"):
            node.wait_ready()
        nid = node.node_id
        if nid in self.fleet:
            raise ValueError(f"node {nid} is already in the fleet")
        now = self.clock.now()
        self.fleet[nid] = node
        self.node_load[nid] = 0
        self.pending_resv[nid] = 0.0
        self.qd_ewma[nid] = 0.0
        self.inflight_cap[nid] = (self.cfg.max_inflight_per_node
                                  or node.max_slots)
        self._node_busy_s[nid] = 0.0
        self._last_traffic[nid] = getattr(node, "ipc_calls", 0)
        self._last_busy[nid] = 0.0
        self._max_prompt = max(self._max_prompt, node.s_max - 1)
        self.registry.register(nid, now)
        if (self.clock.name == "wall" and self.node_backend != "inproc"
                and hasattr(node, "set_continuous")):
            node.set_continuous(True)
        return nid

    def degrade_link(self, src_cluster: int, dst_cluster: int,
                     factor: float) -> None:
        """Fault injection: inflate the RTT of one cross-cluster link by
        ``factor`` (both directions — links fail symmetrically). Stages
        already in transit keep their old release times; everything
        dispatched after this sees the degraded link."""
        if factor <= 0:
            raise ValueError(f"factor must be > 0, got {factor}")
        s = src_cluster % self.rtt_s.shape[0]
        d = dst_cluster % self.rtt_s.shape[0]
        self.rtt_s[s, d] = self._nominal_rtt[s, d] * factor
        self.rtt_s[d, s] = self._nominal_rtt[d, s] * factor

    def restore_link(self, src_cluster: int, dst_cluster: int) -> None:
        """Undo ``degrade_link``: the link returns to its nominal RTT."""
        s = src_cluster % self.rtt_s.shape[0]
        d = dst_cluster % self.rtt_s.shape[0]
        self.rtt_s[s, d] = self._nominal_rtt[s, d]
        self.rtt_s[d, s] = self._nominal_rtt[d, s]

    def retire_node(self, nid: int) -> List[int]:
        """Mid-run elasticity: gracefully drain a node. Its in-flight
        stages re-enter the ready queue as not-yet-dispatched (same
        evacuation as death, without the death event) and the worker shuts
        down. Returns the requeued stage ids."""
        node = self.fleet.pop(nid, None)
        if node is None:
            raise KeyError(f"node {nid} is not in the fleet")
        if len(self.fleet) == 0:
            self.fleet[nid] = node
            raise ValueError(f"cannot retire node {nid}: it is the last "
                             f"node in the fleet")
        now = self.clock.now()
        self._gone_handles.append(node)
        requeued = self._evacuate_node(nid, now)
        self.registry.retire(nid, now)
        close_fleet([node])
        self._max_prompt = max(n.s_max for n in self.fleet.values()) - 1
        return requeued

    # ---------------------------------------------------------- preemption
    def _decode_progress(self, rec: _InFlight) -> int:
        """Tokens the in-flight stage has produced so far. In-process the
        engine mutates the gateway's own Request; a worker process mutates a
        pickled copy, so the handle's last-step progress snapshot stands in
        — both observe the same engine-step boundary on the virtual clock."""
        if self.node_backend != "inproc" and rec.submitted:
            return self.fleet[rec.node_id].out_len(rec.req.req_id)
        return len(rec.req.out)

    def _try_preempt(self, stage: LiveStage, now: float) -> bool:
        """Boundary preemption: evict a batch stage between engine steps so
        an infeasible interactive head can place. The policy decides
        (hysteresis + cooldown); the victim restarts from its prompt."""
        cand = self.view(stage)
        victims = sorted(
            (r for r in self.inflight.values() if not r.stage.interactive),
            key=lambda r: -(r.stage.max_new - self._decode_progress(r)))
        for rec in victims:
            remaining_v = self.cfg.tick_s * max(
                1.0, 1.0 + rec.stage.max_new - self._decode_progress(rec))
            if not self.policy.should_preempt(self, self.view(rec.stage),
                                              remaining_v, cand, now):
                continue
            if rec.submitted:
                if self.fleet[rec.node_id].preempt(rec.model,
                                                   rec.req.req_id) is None:
                    continue   # finished this very tick; nothing to evict
            else:
                self.pending_resv[rec.node_id] -= rec.r_need
            self.inflight.pop(rec.stage.stage_id, None)
            self.node_load[rec.node_id] -= 1
            self.telemetry.preemptions += 1
            ev = self.telemetry.event(rec.stage.stage_id, rec.stage.job_id,
                                      False)
            ev.preemptions += 1
            # bank the aborted attempt's wait before _mark_ready resets it
            ev.prior_wait_s += (max(0.0, ev.dispatch_t - ev.ready_t)
                                + ev.rtt_s + ev.t_act_s)
            ev.rtt_s = ev.t_act_s = 0.0
            self._mark_ready(rec.stage, now)   # requeue from scratch
            return True
        return False

    def _drop_job(self, job_id: int, now: float) -> None:
        """Admission gave up on this job (reject_limit exceeded): withdraw
        its queued stages so the gateway keeps serving everyone else."""
        self.dropped.add(job_id)
        self.telemetry.dropped_jobs += 1
        for s in self.jobs[job_id].stages:
            if s.stage_id not in self.done:
                self._q_discard(s.stage_id)
                # also clear the readiness bookkeeping: a dropped job's
                # stages must not linger as orphan ids in ready_since (the
                # aging input policies read) or in the reject counters
                self.ready_t.pop(s.stage_id, None)
                self._rejects.pop(s.stage_id, None)
