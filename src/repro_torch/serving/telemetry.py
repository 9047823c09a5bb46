"""Gateway telemetry: per-stage timing records, KV-headroom samples and
SLO/latency aggregation for the LIVE serving plane.

Times are in the gateway's CLOCK (``GatewayMetrics.clock`` records which):
deterministic step-driven virtual seconds under the default virtual clock,
real elapsed seconds under the wall clock — so wall-clock rows report queue
delay and SLO attainment against real time. ``wall_act_s`` always records
the real measured activation cost of the underlying ``NodeRuntime``
(host->device transfer + engine construction) regardless of clock.
The summary mirrors ``repro_torch.sim.simulator.SimResult`` so the live plane and
the trace-driven simulator report the same policy-comparison columns.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.clock import RunDeadlineExceeded


@dataclasses.dataclass(frozen=True)
class NodeDeathEvent:
    """One worker death as the membership plane recorded it: when, why
    (transport EOF / heartbeat timeout / dead process reaped), and which
    in-flight stages were evacuated back to the ready queue."""
    node_id: int
    t: float
    cause: str
    requeued_stages: Tuple[int, ...] = ()


@dataclasses.dataclass
class StageEvent:
    """Lifecycle of one workflow stage through the gateway."""
    stage_id: int
    job_id: int
    interactive: bool
    model: str = ""
    node_id: int = -1
    ready_t: float = 0.0          # deps satisfied, entered the global queue
    dispatch_t: float = 0.0       # popped + routed by the policy
    start_t: float = 0.0          # submitted to the node engine (post rtt+act)
    finish_t: float = 0.0         # engine emitted the final token
    rtt_s: float = 0.0
    t_act_s: float = 0.0          # virtual activation latency (residency est.)
    wall_act_s: float = 0.0       # measured wall-clock activation
    out_len: int = 0
    prompt_tokens: int = 0        # live prompt length the engine prefetched
    prefill_avoided: int = 0      # prompt tokens served from the prefix cache
    ttft_s: float = 0.0           # engine-measured wall submit -> first token
                                  # (0.0 when the engine didn't stamp one)
    preemptions: int = 0          # times this stage was evicted + requeued
    rejections: int = 0           # routing/admission failures observed
    prior_wait_s: float = 0.0     # wait accrued by attempts aborted by
                                  # preemption (so eviction can't hide delay)
    worker_deaths: int = 0        # times this stage's node died under it
                                  # (stage re-entered the ready queue)

    @property
    def queue_delay_s(self) -> float:
        """Stage wait as the sim accounts it: queueing + network + cold start,
        summed over every dispatch attempt."""
        return (self.prior_wait_s + max(0.0, self.dispatch_t - self.ready_t)
                + self.rtt_s + self.t_act_s)


@dataclasses.dataclass
class GatewayMetrics:
    policy: str
    slo_attainment: float
    mean_latency_s: float
    p95_latency_s: float
    interactive_queue_delay_s: float
    batch_queue_delay_s: float
    finished_jobs: int
    dropped_jobs: int
    finished_stages: int
    cold_starts: int
    preemptions: int
    admission_rejections: int
    makespan_s: float
    throughput_stages_per_s: float
    min_headroom_bytes: float
    generated_tokens: int
    # physical paged-KV arena (filled by the gateway post-run): worst-node
    # virtual-over-peak-physical KV ratio, fleet-wide peak mapped pages and
    # peak plane-row utilization
    kv_overcommit_ratio: float = 0.0
    arena_peak_pages: int = 0
    arena_utilization: float = 0.0
    truncated_stages: int = 0
    # node backend that produced this row ("inproc" = cooperative stepping
    # inside the gateway process, "process" = one worker process per node)
    # plus the aggregate worker counters: IPC round trips, wall spent on
    # pipe/pickle overhead (engine compute inside step round trips is
    # excluded — that is worker_step_wall_s), and the worker-measured step
    # wall-clock; per-node breakdown in worker_stats (all zero/empty for
    # the in-process backend)
    node_backend: str = "inproc"
    ipc_calls: int = 0
    ipc_wall_s: float = 0.0
    worker_step_wall_s: float = 0.0
    worker_stats: Dict[int, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    # clock plane: which clock produced this row ("virtual" = the
    # deterministic tick clock, "wall" = real monotonic seconds) and the
    # typed run outcome — "deadline_exceeded" + a RunDeadlineExceeded
    # record when the clock's max_run_s fired before every job finished,
    # instead of the old silent max_ticks truncation
    clock: str = "virtual"
    run_outcome: str = "completed"
    run_deadline: Optional[RunDeadlineExceeded] = None
    # wall-clock-only telemetry (zero/empty on the virtual clock so virtual
    # rows stay bit-identical across node backends): makespan in real
    # seconds, per-node engine-busy fraction of the run, and the fleet
    # overlap factor (sum of per-node busy seconds / makespan — above 1.0
    # only when engine compute genuinely overlapped across nodes, which the
    # in-process backend can never achieve)
    wall_makespan_s: float = 0.0
    node_busy_frac: Dict[int, float] = dataclasses.field(
        default_factory=dict)
    overlap_factor: float = 0.0
    # tail percentiles alongside the p95 column: end-to-end job latency,
    # per-stage queue delay and per-stage service latency (ready -> finish).
    # Tail columns (p99/p99.9) are 0.0 on empty or single-sample runs — an
    # extreme-percentile estimate from < 2 observations is noise, and the
    # fleet-summed benchmark paths must never see NaN/inf in a tail cell
    # (see tail_percentile)
    p99_latency_s: float = 0.0
    p999_latency_s: float = 0.0
    queue_delay_p95_s: float = 0.0
    queue_delay_p99_s: float = 0.0
    queue_delay_p999_s: float = 0.0
    stage_latency_p95_s: float = 0.0
    stage_latency_p99_s: float = 0.0
    stage_latency_p999_s: float = 0.0
    # cross-stage prefix-cache plane: prompt tokens the engines would have
    # prefilled vs. tokens served from cached prefix pages, plus the summed
    # per-node index counters (empty when the cache is disabled fleet-wide)
    prefill_tokens_total: int = 0
    prefill_tokens_avoided: int = 0
    prefix_stats: Dict[str, float] = dataclasses.field(default_factory=dict)
    # engine iteration scheduler (chunked prefill / continuous batching):
    # wall-measured TTFT percentiles over finished stages (engine submit ->
    # first output token; 0.0 when no stage carried a stamp — virtual-clock
    # parity suites exclude these, like the other wall-side counters) and
    # the fleet-summed per-iteration token split + compile/fusion counters
    # (deterministic: identical across node backends under either clock)
    ttft_p50_s: float = 0.0
    ttft_p95_s: float = 0.0
    engine_prefill_tokens: int = 0
    engine_decode_tokens: int = 0
    engine_prefill_compiles: int = 0
    engine_fused_steps: int = 0
    engine_steps: int = 0
    # decode horizon (multi-token on-device decode): fleet-summed horizon
    # launches, decode host round-trips, and the headline ratio — host
    # syncs per emitted decode token (1.0 at H=1, ~1/H in pure decode)
    engine_horizon_steps: int = 0
    engine_decode_syncs: int = 0
    host_syncs_per_token: float = 0.0
    # transport + membership plane: worker deaths witnessed this
    # run, the in-flight stages evacuated back to the ready queue because
    # of them, end-of-run liveness state per node, idle-ping misses, nodes
    # the straggler detector flags (wall clock only — observations are
    # real seconds; empty on virtual rows so parity holds), and socket
    # transport byte counters (zero for inproc/process backends)
    node_deaths: int = 0
    requeued_stages: int = 0
    death_events: List[NodeDeathEvent] = dataclasses.field(
        default_factory=list)
    liveness: Dict[int, str] = dataclasses.field(default_factory=dict)
    heartbeat_misses: int = 0
    straggler_nodes: List[int] = dataclasses.field(default_factory=list)
    rpc_bytes_sent: int = 0
    rpc_bytes_recv: int = 0
    # fault-injection / tail-scenario plane: how long the fleet took
    # to finish the last stage evacuated by a node death (max over deaths of
    # death time -> final requeued-stage finish; 0.0 when no death requeued
    # work or nothing requeued finished), plus per-model demand served —
    # finished stages and generated tokens keyed by resolved model name
    # (the per-family utilization columns in BENCH_tail_scenarios.json)
    recovery_time_s: float = 0.0
    stages_by_model: Dict[str, int] = dataclasses.field(default_factory=dict)
    tokens_by_model: Dict[str, int] = dataclasses.field(default_factory=dict)

    def row(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def tail_percentile(xs: List[float], q: float) -> float:
    """Extreme-tail percentile (p99/p99.9) with defined edge cases: fewer
    than two samples returns 0.0 — ``np.percentile`` of an empty array is
    NaN (and would raise on a bare empty list), and a "tail" read off a
    single observation is noise that poisons fleet-summed columns."""
    if len(xs) < 2:
        return 0.0
    return float(np.percentile(xs, q))


class Telemetry:
    """Collects stage events + node headroom samples during a gateway run."""

    def __init__(self) -> None:
        self.events: Dict[int, StageEvent] = {}
        self.headroom: Dict[int, List[float]] = {}
        self.cold_starts = 0
        self.preemptions = 0
        self.admission_rejections = 0
        self.dropped_jobs = 0
        # per-node worker-process counters (process backend only): IPC round
        # trips, pipe/pickle overhead wall, worker-measured step wall-clock
        self.worker_stats: Dict[int, Dict[str, float]] = {}
        # membership plane: worker deaths in arrival order
        self.node_deaths: List[NodeDeathEvent] = []

    # ------------------------------------------------------------- recording
    def event(self, stage_id: int, job_id: int, interactive: bool) -> StageEvent:
        ev = self.events.get(stage_id)
        if ev is None:
            ev = StageEvent(stage_id=stage_id, job_id=job_id,
                            interactive=interactive)
            self.events[stage_id] = ev
        return ev

    def sample_headroom(self, node_id: int, headroom: float) -> None:
        self.headroom.setdefault(node_id, []).append(float(headroom))

    def record_worker(self, node_id: int, stats: Dict[str, float]) -> None:
        """End-of-run snapshot of one worker handle's IPC/wall counters."""
        self.worker_stats[node_id] = dict(stats)

    def node_death(self, ev: NodeDeathEvent) -> None:
        self.node_deaths.append(ev)

    # ------------------------------------------------------------ aggregation
    def summary(self, policy: str, jobs, job_finish: Dict[int, float],
                interactive_budget_s: float, now: float) -> GatewayMetrics:
        """``jobs``: iterable with .job_id, .interactive, .arrival_s,
        .deadline_s and .stages (each stage with .stage_id)."""
        lat: List[float] = []
        slo_ok: List[bool] = []
        int_delays: List[float] = []
        batch_delays: List[float] = []
        for j in jobs:
            waits = sum(self.events[s.stage_id].queue_delay_s
                        for s in j.stages if s.stage_id in self.events
                        and self.events[s.stage_id].finish_t > 0)
            if j.interactive:
                int_delays.append(waits)
            else:
                batch_delays.append(waits)
            if j.job_id not in job_finish:
                slo_ok.append(False)
                continue
            l = job_finish[j.job_id] - j.arrival_s
            lat.append(l)
            if j.interactive:
                slo_ok.append(waits <= interactive_budget_s)
            else:
                slo_ok.append(l <= j.deadline_s)
        finished = [e for e in self.events.values() if e.finish_t > 0]
        makespan = max((e.finish_t for e in finished), default=now)
        head_min = min((min(v) for v in self.headroom.values() if v),
                       default=float("inf"))

        def pct(xs: List[float], q: float, empty: float) -> float:
            return float(np.percentile(xs, q)) if xs else empty

        qdel = [e.queue_delay_s for e in finished]
        slat = [e.finish_t - e.ready_t for e in finished]
        ttft = [e.ttft_s for e in finished if e.ttft_s > 0]
        inf = float("inf")
        recovery: List[float] = []
        for d in self.node_deaths:
            fins = [self.events[s].finish_t for s in d.requeued_stages
                    if s in self.events and self.events[s].finish_t > 0]
            if fins:
                recovery.append(max(fins) - d.t)
        stages_by_model: Dict[str, int] = {}
        tokens_by_model: Dict[str, int] = {}
        for e in finished:
            if e.model:
                stages_by_model[e.model] = stages_by_model.get(e.model, 0) + 1
                tokens_by_model[e.model] = (tokens_by_model.get(e.model, 0)
                                            + e.out_len)
        return GatewayMetrics(
            policy=policy,
            slo_attainment=float(np.mean(slo_ok)) if slo_ok else 0.0,
            mean_latency_s=float(np.mean(lat)) if lat else float("inf"),
            p95_latency_s=pct(lat, 95, inf),
            p99_latency_s=tail_percentile(lat, 99),
            p999_latency_s=tail_percentile(lat, 99.9),
            queue_delay_p95_s=pct(qdel, 95, 0.0),
            queue_delay_p99_s=tail_percentile(qdel, 99),
            queue_delay_p999_s=tail_percentile(qdel, 99.9),
            stage_latency_p95_s=pct(slat, 95, 0.0),
            stage_latency_p99_s=tail_percentile(slat, 99),
            stage_latency_p999_s=tail_percentile(slat, 99.9),
            recovery_time_s=max(recovery, default=0.0),
            stages_by_model=stages_by_model,
            tokens_by_model=tokens_by_model,
            ttft_p50_s=pct(ttft, 50, 0.0),
            ttft_p95_s=pct(ttft, 95, 0.0),
            prefill_tokens_total=sum(e.prompt_tokens for e in finished),
            prefill_tokens_avoided=sum(e.prefill_avoided for e in finished),
            interactive_queue_delay_s=(float(np.mean(int_delays))
                                       if int_delays else 0.0),
            batch_queue_delay_s=(float(np.mean(batch_delays))
                                 if batch_delays else 0.0),
            finished_jobs=len(job_finish),
            dropped_jobs=self.dropped_jobs,
            finished_stages=len(finished),
            cold_starts=self.cold_starts,
            preemptions=self.preemptions,
            admission_rejections=self.admission_rejections,
            makespan_s=float(makespan),
            throughput_stages_per_s=(len(finished) / makespan
                                     if makespan > 0 else 0.0),
            min_headroom_bytes=float(head_min),
            generated_tokens=sum(e.out_len for e in finished))
