"""The port's worker-process backend against its in-process fleet, on the CPU.

Workers are spawned with ``WorkerSpec.device="cpu"``. Under the gateway's
virtual clock a fleet of worker processes must give the in-process fleet's
result bit for bit: every stage on the same node with the same tokens and
times, and every ``GatewayMetrics`` key equal but the backend-only ones
(the backend tag, IPC and worker wall-clock accounting, the socket byte
counters, the wall-side TTFT). The in-process fleet is held against the JAX
package's in ``test_torch_gateway.py``, so no JAX child is needed here.
"""
import multiprocessing as mp

import numpy as np
import pytest
import torch

from _stubs import StubPred
from repro_torch.core.predictor.features import StageObservation
from repro_torch.data.tracegen import generate_trace
from repro_torch.serving.cluster import (ClusterSpec, LiveJob, LiveStage,
                                         NodeSpec, build_fleet,
                                         jobs_from_trace)
from repro_torch.serving.engine import PromptTooLongError, Request
from repro_torch.serving.gateway import ClusterGateway, GatewayConfig
from repro_torch.serving.worker import (NodeHandle, WorkerSpec, close_fleet,
                                        spawn_fleet)

RTT = np.array([[0.001, 0.04], [0.04, 0.001]])
ZOO_NAMES = ("qwen3-8b",)

# GatewayMetrics fields that legitimately differ between backends
# (tests/test_worker.py's list)
BACKEND_ONLY = {"node_backend", "ipc_calls", "ipc_wall_s",
                "worker_step_wall_s", "worker_stats",
                "rpc_bytes_sent", "rpc_bytes_recv",
                "ttft_p50_s", "ttft_p95_s"}
TWO_NODES = [NodeSpec(0, max_slots=2), NodeSpec(1, max_slots=2)]


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """One intra-op thread in this process and in every worker it spawns
    (workers inherit this environment): on a shared host, processes that
    each spin a pool of threads slow one another down a hundredfold."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def trace_jobs():
    return jobs_from_trace(generate_trace(3, rate=2.0, seed=5),
                           n_clusters=2, prompt_cap=8, gen_cap=8, seed=2)


def run_fleet(backend, make_jobs, specs, policy="fcfs", predictor=None,
              **fleet_kw):
    """Serve ``make_jobs()`` on a fresh fleet of ``backend``; returns the
    metrics and, per stage, (node, tokens, out_len, ready, dispatch,
    submit and finish times, preemptions, queue delay)."""
    spec = ClusterSpec(nodes=tuple(specs), rtt_s=RTT, model_names=ZOO_NAMES)
    fleet = build_fleet(spec, backend=backend, device="cpu", **fleet_kw)
    tokens = {}
    try:
        gw = ClusterGateway(fleet, RTT, predictor=predictor, policy=policy,
                            cfg=GatewayConfig(node_backend=backend))
        complete = gw._complete

        def record(stage, model, req, now):
            tokens[stage.stage_id] = list(req.out)
            complete(stage, model, req, now)

        gw._complete = record
        m = gw.run(make_jobs())
        events = {sid: (e.node_id, tokens.get(sid), e.out_len, e.ready_t,
                        e.dispatch_t, e.start_t, e.finish_t, e.preemptions,
                        e.queue_delay_s)
                  for sid, e in gw.telemetry.events.items()}
    finally:
        close_fleet(fleet)       # covers gateway-constructor failures too
    return m, events


def assert_parity(m_in, ev_in, m_w, ev_w):
    assert ev_in == ev_w                       # same nodes/tokens/times
    row_in, row_w = m_in.row(), m_w.row()
    assert {k: v for k, v in row_w.items() if k not in BACKEND_ONLY} == \
        {k: v for k, v in row_in.items() if k not in BACKEND_ONLY}


def no_tensor(obj) -> bool:
    """True when ``obj`` (a reply from a worker) holds no torch tensor."""
    if isinstance(obj, torch.Tensor):
        return False
    if isinstance(obj, dict):
        return all(no_tensor(k) and no_tensor(v) for k, v in obj.items())
    if isinstance(obj, (list, tuple, set)):
        return all(no_tensor(v) for v in obj)
    if hasattr(obj, "__dict__"):
        return no_tensor(vars(obj))
    return True


@pytest.mark.parametrize("policy", ["fcfs", "maestro"])
def test_process_backend_equals_the_inproc_fleet(policy):
    pred = StubPred(length=lambda obs: 8.0 + obs.prompt_len % 13)
    m_in, ev_in = run_fleet("inproc", trace_jobs, TWO_NODES, policy, pred)
    m_proc, ev_proc = run_fleet("process", trace_jobs, TWO_NODES, policy,
                                pred)
    assert m_in.finished_jobs == 3 and m_in.node_backend == "inproc"
    assert m_proc.node_backend == "process"
    assert_parity(m_in, ev_in, m_proc, ev_proc)
    assert {ev[0] for ev in ev_in.values()} == {0, 1}
    assert m_proc.ipc_calls > 0 and m_proc.ipc_wall_s > 0
    assert set(m_proc.worker_stats) == {0, 1}
    for stats in m_proc.worker_stats.values():     # every node saw traffic
        assert stats["ipc_calls"] > 0
        assert stats["worker_step_wall_s"] > 0
    assert m_in.ipc_calls == 0 and not m_in.worker_stats


def _obs():
    return StageObservation(app=0, role=0, position=0.0, invocation_idx=0,
                            tools_available=0, cot=False, prompt_len=32,
                            model_id=0, text="stage", src_cluster=0)


def preemption_jobs():
    batch = LiveJob(0, "b", False, 0.0, [
        LiveStage(stage_id=0, job_id=0, deps=[], obs=_obs(),
                  interactive=False, tokens=[1, 2, 3, 4], max_new=40)])
    inter = LiveJob(1, "i", True, 0.3, [
        LiveStage(stage_id=1, job_id=1, deps=[], obs=_obs(),
                  interactive=True, tokens=[5, 6, 7, 8], max_new=5)])
    return [batch, inter]


def test_preemption_equals_the_inproc_fleet():
    """Boundary preemption reads decode progress, which lives in the child
    on the process backend: the decisions are the in-process fleet's."""
    specs = [NodeSpec(0, max_slots=1)]
    m_in, ev_in = run_fleet("inproc", preemption_jobs, specs, "maestro",
                            StubPred())
    m_proc, ev_proc = run_fleet("process", preemption_jobs, specs,
                                "maestro", StubPred())
    assert m_in.preemptions >= 1                   # the path was exercised
    assert_parity(m_in, ev_in, m_proc, ev_proc)


def test_worker_handle_protocol_and_records():
    """One spawned worker: signal snapshots, admission estimates, typed
    error propagation, kv stats, the child's records, idempotent shutdown.
    Every reply is plain data, and the child loaded neither JAX nor the JAX
    package."""
    h = NodeHandle(WorkerSpec(node_id=7, cluster_id=1,
                              model_names=ZOO_NAMES, max_slots=2, s_max=32,
                              device="cpu"))
    try:
        h.wait_ready()
        assert set(h.profiles) == set(ZOO_NAMES)
        sig = h.signal()
        assert sig.node_id == 7 and sig.cluster_id == 1
        assert sig.headroom > 0
        assert h.can_admit(1024.0, ZOO_NAMES[0])
        assert h.t_act(ZOO_NAMES[0]) > 0           # cold model
        assert h.degradation_cost(0.0) == 0.0
        with pytest.raises(PromptTooLongError):    # typed, not RuntimeError
            h.submit(ZOO_NAMES[0], Request(req_id=1,
                                           tokens=list(range(40)),
                                           max_new=4))
        h.reset_records()
        h.submit(ZOO_NAMES[0], Request(req_id=2, tokens=[1, 2, 3],
                                       max_new=3))
        h.submit(ZOO_NAMES[0], Request(req_id=3, tokens=[4, 5, 6, 7],
                                       max_new=20))
        out = {}
        for _ in range(20):
            for model, reqs in h.step().items():
                for r in reqs:
                    out[r.req_id] = r
            if out:
                break
        assert out[2].out and len(out[2].out) == 3
        stats = h.kv_stats()
        assert stats["n_engines"] == 1
        assert stats["arena_peak_pages"] > 0
        preempted = h.preempt(ZOO_NAMES[0], 3)
        assert preempted is not None and preempted.req_id == 3
        rec = h.records()
        replies = (h.profiles, sig, stats, out, preempted, rec)
        assert all(no_tensor(r) for r in replies)
        assert rec["foreign_modules"] == []
        assert rec["launches"] == {k: 0 for k in rec["launches"]}
        assert rec["plain_calls"]["paged_attention"] > 0   # CPU: plain
        assert rec["max_memory_allocated"] is None         # no card
        (act,) = rec["activations"]
        assert act["model"] == ZOO_NAMES[0] and act["cause"] == "submit"
        assert act["req_ids"] == [1]        # activated before it raised
        assert rec["offloads"] == []
        h.reset_records()
        assert h.records()["plain_calls"] == {
            k: 0 for k in rec["plain_calls"]}
        assert h.worker_stats()["ipc_calls"] == h.ipc_calls > 0
    finally:
        h.close()
        h.close()                                  # second close is a no-op
    assert not h.proc.is_alive()


def test_partial_spawn_failure_leaks_no_workers():
    """If one node of a fleet fails its boot handshake, spawn_fleet tears
    down every already-started worker before raising."""
    before = {p.pid for p in mp.active_children()}
    specs = [WorkerSpec(node_id=0, cluster_id=0, model_names=ZOO_NAMES,
                        device="cpu"),
             WorkerSpec(node_id=1, cluster_id=0,
                        model_names=("no-such-model",), device="cpu")]
    with pytest.raises(RuntimeError, match="failed to boot"):
        spawn_fleet(specs)
    leaked = [p for p in mp.active_children()
              if p.pid not in before and p.is_alive()]
    assert not leaked, f"spawn failure leaked workers: {leaked}"


def test_close_fleet_safe_on_half_constructed_handles():
    """close_fleet / handle.close on handles whose constructor never
    completed (no process, no pipe), twice."""
    h = NodeHandle.__new__(NodeHandle)
    h._init_state(WorkerSpec(node_id=3, cluster_id=0,
                             model_names=ZOO_NAMES, device="cpu"))
    close_fleet([h, object()])     # non-handle members are skipped
    close_fleet([h])               # second close is a no-op


def test_backend_names_and_fleet_mismatch_are_errors():
    """Config/fleet mismatch is a construction-time error, not a hang."""
    spec = ClusterSpec(nodes=(NodeSpec(0),), rtt_s=RTT,
                       model_names=ZOO_NAMES)
    fleet = build_fleet(spec, device="cpu")
    with pytest.raises(ValueError, match="process"):
        ClusterGateway(fleet, RTT, policy="fcfs",
                       cfg=GatewayConfig(node_backend="process"))
    with pytest.raises(ValueError, match="node_backend"):
        ClusterGateway(fleet, RTT, policy="fcfs",
                       cfg=GatewayConfig(node_backend="threads"))
    with pytest.raises(ValueError, match="backend"):
        build_fleet(spec, backend="threads", device="cpu")
    with pytest.raises(ValueError, match="worker_addresses"):
        build_fleet(spec, backend="process", device="cpu",
                    worker_addresses=["127.0.0.1:1"])
    with pytest.raises(ValueError, match="worker backend"):
        spawn_fleet([], backend="threads")
