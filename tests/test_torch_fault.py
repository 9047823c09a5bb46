"""Fault recovery in the port, on the CPU: the reference's
``tests/test_fault_recovery.py`` cases over the port's fleets.

A socket worker SIGKILLed mid-run under the wall clock (by hand and by a
scripted ``FaultPlan`` with a degraded link) is absorbed by the membership
plane: its in-flight stages re-enter the queue, the run completes on the
survivor, and the death is typed telemetry. Under the virtual clock the
in-process plan is deterministic and gives the JAX package's outcome: the
same fired log, every stage on the same node with the same tokens and
times, and the same metrics but TTFT and ``engine_prefill_compiles``.
"""
import dataclasses
import os
import signal

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.predictor import cost_model as jax_cm
from repro.data import tracegen as jax_tg
from repro.models import build_model as jax_build
from repro.serving import cluster as jax_cluster
from repro.serving import faultplan as jax_faultplan
from repro.serving import gateway as jax_gateway
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.predictor import cost_model as cm
from repro_torch.data import tracegen as tg
from repro_torch.data.tracegen import generate_trace
from repro_torch.models import build_model
from repro_torch.serving import cluster, faultplan, gateway
from repro_torch.serving.cluster import (ClusterSpec, NodeSpec, build_fleet,
                                         jobs_from_trace)
from repro_torch.serving.faultplan import (DegradeLink, FaultPlan,
                                           KillWorker, RestoreLink)
from repro_torch.serving.gateway import ClusterGateway, GatewayConfig

RTT = np.array([[0.001, 0.04], [0.04, 0.001]])
ONE = ("qwen3-8b",)
# wall-side metrics, and the jit-compile count the port reports as 0
UNCOMPARED = {"ttft_p50_s", "ttft_p95_s", "engine_prefill_compiles"}


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """One intra-op thread here and in every spawned worker (see
    ``test_torch_worker.py``)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the victim's death reaches the gateway through its transport; a
# survivor starved of CPU on a shared host must not time out as dead
DEAD_AFTER_S = 60.0


def _socket_fleet():
    spec = ClusterSpec(nodes=(NodeSpec(0), NodeSpec(1)), model_names=ONE)
    return build_fleet(spec, backend="socket", device="cpu")


def test_kill_worker_mid_run_requeues_and_completes():
    jobs = jobs_from_trace(generate_trace(n_jobs=6, seed=3, rate=4.0),
                           n_clusters=2, gen_cap=12)
    fleet = _socket_fleet()
    gw = ClusterGateway(fleet, RTT, policy="fcfs",
                        cfg=GatewayConfig(node_backend="socket",
                                          clock="wall", heartbeat_s=0.05,
                                          dead_after_s=DEAD_AFTER_S))
    victim = fleet[0]
    try:
        gw.warmup()
        gw.submit_jobs(jobs)
        gw.clock.restart()
        gw.clock.set_deadline(180.0)
        killed = False
        while gw._unfinished() and not gw.clock.expired():
            gw.step()
            if not killed and any(r.submitted and r.node_id == victim.node_id
                                  for r in gw.inflight.values()):
                os.kill(victim.proc.pid, signal.SIGKILL)
                killed = True
        assert killed, "victim node never received submitted work"
        m = gw.metrics()
        total = sum(len(j.stages) for j in jobs)
        assert m.run_outcome == "completed"
        assert m.finished_jobs == len(jobs)
        assert m.finished_stages == total
        fins = [e for e in gw.telemetry.events.values() if e.finish_t > 0]
        assert len(fins) == total
        assert m.node_deaths == 1
        assert m.requeued_stages >= 1
        (death,) = m.death_events
        assert death.node_id == victim.node_id
        assert len(death.requeued_stages) == m.requeued_stages
        assert m.liveness[victim.node_id] == "dead"
        assert all(v == "healthy"
                   for n, v in m.liveness.items() if n != victim.node_id)
        for sid in death.requeued_stages:
            ev = gw.telemetry.events[sid]
            assert ev.finish_t > 0 and ev.node_id != victim.node_id
            assert ev.worker_deaths >= 1
    finally:
        gw.close()
        gw.close()                       # close is idempotent post-death


def test_faultplan_scripted_kill_and_link_degradation_socket():
    deadline_s = 180.0
    jobs = jobs_from_trace(generate_trace(n_jobs=8, seed=3, rate=6.0),
                           n_clusters=2, gen_cap=12)
    fleet = _socket_fleet()
    gw = ClusterGateway(fleet, RTT, policy="fcfs",
                        cfg=GatewayConfig(node_backend="socket",
                                          clock="wall", heartbeat_s=0.05,
                                          dead_after_s=DEAD_AFTER_S,
                                          max_run_s=deadline_s))
    victim = fleet[0].node_id
    # anchored to the trace's arrival span: the run cannot drain before
    # the last arrival, so every event fires
    span = max(j.arrival_s for j in jobs)
    plan = FaultPlan([
        KillWorker(at_s=0.6 * span, node_id=victim),
        DegradeLink(at_s=0.2 * span, src_cluster=0, dst_cluster=1,
                    factor=20.0),
        RestoreLink(at_s=span, src_cluster=0, dst_cluster=1),
    ])
    try:
        gw.warmup()
        m = gw.run(jobs, fault_plan=plan)
        total = sum(len(j.stages) for j in jobs)
        assert [w.split(":")[0] for _, w in plan.fired] == \
            ["degrade link 0<->1 x20", f"kill node {victim}",
             "restore link 0<->1"]
        assert "SIGKILL" in plan.fired[1][1]
        assert np.allclose(gw.rtt_s, RTT)
        assert m.run_outcome == "completed"
        assert m.finished_jobs == len(jobs)
        assert m.finished_stages == total
        fins = [e for e in gw.telemetry.events.values() if e.finish_t > 0]
        assert len(fins) == total
        assert m.node_deaths == 1
        (death,) = m.death_events
        assert death.node_id == victim
        assert m.liveness[victim] == "dead"
        for sid in death.requeued_stages:
            ev = gw.telemetry.events[sid]
            assert ev.finish_t > 0 and ev.node_id != victim
        if death.requeued_stages:
            assert 0.0 < m.recovery_time_s < deadline_s
    finally:
        gw.close()


# ------------------------------------- the virtual in-process plan, parity
@pytest.fixture(scope="module")
def one_model_zoos():
    """Reduced qwen3-8b as a JAX model with a numpy host tree (as the
    reference's ``build_zoo`` draws it) and the same weights in the port's
    layout."""
    jm = jax_build(jax_config(ONE[0]).reduced())
    jhost = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    cfg = get_config(ONE[0]).reduced()
    host = params_from_jax(jhost, cfg, "cpu")
    return ({ONE[0]: jm}, {ONE[0]: jhost},
            {ONE[0]: build_model(cfg, host, device="cpu")}, {ONE[0]: host})


def _virtual_plan_run(pkg, zoo, host, port):
    """One in-process run under the virtual clock with a kill at 0.6 s and
    a degraded link at 0.7 s. Returns per stage (node, tokens, out_len,
    ready, dispatch, submit and finish times), the metrics' row and the
    fired log."""
    cl, gwm, fp, trace_mod = pkg
    spec = cl.ClusterSpec(nodes=(cl.NodeSpec(0), cl.NodeSpec(1)),
                          model_names=ONE)
    if port:
        fleet = cl.build_fleet(spec, zoo=zoo, host=host, device="cpu")
        ref_hw = cm.HardwareSpec(**dataclasses.asdict(jax_cm.HardwareSpec()))
        for node in fleet:
            # route by the reference's modelled seconds
            for n, prof in node.profiles.items():
                node.profiles[n] = dataclasses.replace(prof, hw=ref_hw)
            node.residency.hw = ref_hw
    else:
        fleet = cl.build_fleet(spec, zoo=zoo, host=host)
    jobs = cl.jobs_from_trace(trace_mod.generate_trace(n_jobs=6, seed=3,
                                                       rate=4.0),
                              n_clusters=2, gen_cap=8)
    plan = fp.FaultPlan([
        fp.KillWorker(at_s=0.6, node_id=0),
        fp.DegradeLink(at_s=0.7, src_cluster=0, dst_cluster=1, factor=30.0),
    ])
    gw = gwm.ClusterGateway(fleet, RTT.copy(), policy="fcfs")
    tokens = {}
    complete = gw._complete

    def record(stage, model, req, now):
        tokens[stage.stage_id] = list(req.out)
        complete(stage, model, req, now)

    gw._complete = record
    m = gw.run(jobs, fault_plan=plan)
    events = {sid: (e.node_id, tokens.get(sid), e.out_len, e.ready_t,
                    e.dispatch_t, e.start_t, e.finish_t, e.worker_deaths)
              for sid, e in gw.telemetry.events.items() if e.finish_t > 0}
    gw.close()
    row = {k: v for k, v in m.row().items() if k not in UNCOMPARED}
    return events, row, plan.fired, m


def test_faultplan_virtual_inproc_deterministic_and_equal_to_the_reference(
        one_model_zoos):
    jzoo, jhost, zoo, host = one_model_zoos
    port = (cluster, gateway, faultplan, tg)
    ref = (jax_cluster, jax_gateway, jax_faultplan, jax_tg)
    ev1, row1, fired1, m1 = _virtual_plan_run(port, zoo, host, True)
    ev2, row2, fired2, _ = _virtual_plan_run(port, zoo, host, True)
    jev, jrow, jfired, _ = _virtual_plan_run(ref, jzoo, jhost, False)
    total = sum(len(j.stages) for j in tg.generate_trace(n_jobs=6, seed=3,
                                                         rate=4.0))
    assert ev1 == ev2 and fired1 == fired2 and row1 == row2
    assert m1.node_deaths == 1 and m1.finished_stages == total
    assert len(ev1) == total
    assert "reported death" in fired1[0][1]
    assert fired1 == jfired
    assert ev1 == jev
    assert row1 == jrow


def test_faultplan_single_use():
    plan = FaultPlan([KillWorker(at_s=1.0, node_id=0)])

    class _Clock:
        def now(self):
            return 0.0

        def call_at(self, t, payload):
            pass

    class _GW:
        clock = _Clock()

    plan.arm(_GW())
    with pytest.raises(RuntimeError, match="single-use"):
        plan.arm(_GW())
