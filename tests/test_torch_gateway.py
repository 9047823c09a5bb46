"""The port's live gateway against the JAX package's, on the CPU.

The JAX ``ClusterGateway`` serves a JAX in-process fleet and the port's
serves a torch in-process fleet (``device="cpu"``) built from the same
converted weights, under the virtual clock and over the same jobs. The
gateway's arithmetic is numpy on both sides and the reduced f32 models give
identical greedy tokens, so the tolerance is equality: every stage must run
on the same node, emit the same tokens and be ready, dispatched, submitted
and finished at the same clock times, and ``GatewayMetrics.row()`` must be
equal except for the wall-side TTFT keys and ``engine_prefill_compiles``
(the port compiles nothing and reports 0). The port's nodes take the
reference's ``HardwareSpec`` because the gateway routes by modelled
seconds.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _stubs import StubPred
from repro.configs import get_config as jax_config
from repro.core.predictor import cost_model as jax_cm
from repro.core.predictor import length_model as jax_lm
from repro.core.predictor.features import StageObservation as JaxObs
from repro.core.predictor.gbdt import GBDTConfig as JaxGBDTConfig
from repro.data import tracegen as jax_tg
from repro.models import build_model as jax_build
from repro.serving import cluster as jax_cluster
from repro.serving import gateway as jax_gateway
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.predictor import cost_model as cm
from repro_torch.core.predictor import length_model as lm
from repro_torch.core.predictor.features import StageObservation
from repro_torch.core.predictor.gbdt import GBDTConfig
from repro_torch.core.sched.policies import registered_policies
from repro_torch.data import tracegen as tg
from repro_torch.models import build_model
from repro_torch.serving import cluster, gateway
from repro_torch.serving.clock import WallClock
from repro_torch.serving.engine import Request


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch intra-op thread: test processes that each spin a pool of
    threads on a shared host slow one another down a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ZOO = cluster.DEFAULT_ZOO
REF_HW = cm.HardwareSpec(**dataclasses.asdict(jax_cm.HardwareSpec()))
RTT = np.array([[0.001, 0.04], [0.04, 0.001]])
# wall-side metrics, and the jit-compile count the port reports as 0
UNCOMPARED = {"ttft_p50_s", "ttft_p95_s", "engine_prefill_compiles"}
# the StageEvent fields measured on the host's clock
WALL_FIELDS = {"wall_act_s", "ttft_s"}


@pytest.fixture(scope="module")
def zoos():
    """The reduced default zoo as JAX models with numpy host trees, and the
    same weights in the port's layout."""
    jzoo, jhost, zoo, host = {}, {}, {}, {}
    for i, name in enumerate(ZOO):
        jzoo[name] = jax_build(jax_config(name).reduced())
        jhost[name] = jax.tree.map(
            np.asarray, jzoo[name].init(jax.random.PRNGKey(1 + i)))
        cfg = get_config(name).reduced()
        host[name] = params_from_jax(jhost[name], cfg, "cpu")
        zoo[name] = build_model(cfg, host[name], device="cpu")
    return (jzoo, jhost), (zoo, host)


def _predictor(pkg_tg, pkg_lm, gbdt_cfg):
    train, _ = pkg_tg.stratified_temporal_split(
        pkg_tg.generate_trace(60, seed=9))
    cfg = pkg_lm.PredictorConfig(
        cls=gbdt_cfg(objective="logloss", n_trees=10, max_leaves=7),
        reg=gbdt_cfg(n_trees=12, max_leaves=7))
    return pkg_lm.MaestroPred(cfg).fit(
        [s.obs for s in train], np.array([s.true_len for s in train], float),
        np.array([float(s.tool_call) for s in train]))


@pytest.fixture(scope="module")
def predictors():
    return (_predictor(jax_tg, jax_lm, JaxGBDTConfig),
            _predictor(tg, lm, GBDTConfig))


class _Side:
    """One package's cluster, gateway and trace modules."""

    def __init__(self, cl, gw, trace, zoo, host, obs_cls, port):
        self.cl, self.gw, self.tg = cl, gw, trace
        self.zoo, self.host, self.obs_cls, self.port = zoo, host, obs_cls, port

    def fleet(self, specs, zoo_names=ZOO):
        spec = self.cl.ClusterSpec(nodes=tuple(
            self.cl.NodeSpec(*a, **k) for a, k in specs), rtt_s=RTT,
            model_names=zoo_names)
        zoo = {n: self.zoo[n] for n in zoo_names}
        host = {n: self.host[n] for n in zoo_names}
        if not self.port:
            return self.cl.build_fleet(spec, zoo=zoo, host=host)
        fleet = self.cl.build_fleet(spec, zoo=zoo, host=host, device="cpu")
        for node in fleet:
            # route by the reference's modelled seconds
            for n, prof in node.profiles.items():
                node.profiles[n] = dataclasses.replace(prof, hw=REF_HW)
            node.residency.hw = REF_HW
        return fleet

    def serve(self, fleet, jobs, predictor=None, policy="maestro", cfg=None,
              **run_kw):
        gw = self.gw.ClusterGateway(fleet, RTT, predictor=predictor,
                                    policy=policy, cfg=cfg)
        tokens = {}
        complete = gw._complete

        def record(stage, model, req, now):
            tokens[stage.stage_id] = (model, list(req.out), req.truncated)
            complete(stage, model, req, now)

        gw._complete = record
        m = gw.run(jobs, **run_kw)
        return gw, m, tokens


def _sides(zoos):
    (jzoo, jhost), (zoo, host) = zoos
    return (_Side(jax_cluster, jax_gateway, jax_tg, jzoo, jhost, JaxObs,
                  False),
            _Side(cluster, gateway, tg, zoo, host, StageObservation, True))


def _stage_rows(gw):
    return {sid: {k: v for k, v in dataclasses.asdict(e).items()
                  if k not in WALL_FIELDS}
            for sid, e in gw.telemetry.events.items()}


def _assert_same(ref, port):
    (jgw, jm, jtok), (pgw, pm, ptok) = ref, port
    assert ptok == jtok
    assert _stage_rows(pgw) == _stage_rows(jgw)
    jrow, prow = jm.row(), pm.row()
    assert {k: v for k, v in prow.items() if k not in UNCOMPARED} == \
        {k: v for k, v in jrow.items() if k not in UNCOMPARED}
    assert pm.engine_prefill_compiles == 0


def _both(zoos, specs, make_jobs, zoo_names=ZOO, **serve_kw):
    """Serve the same jobs on both packages; ``make_jobs(side)`` builds
    them with the side's own classes. Returns (reference, port) results."""
    out = []
    for side in _sides(zoos):
        out.append(side.serve(side.fleet(specs, zoo_names), make_jobs(side),
                              **{k: (v(side) if callable(v)
                                     and k == "predictor" else v)
                                 for k, v in serve_kw.items()}))
    _assert_same(*out)
    return out


# ------------------------------------------------- parity, every policy
TWO_NODES = [((0,), dict(max_slots=2)),
             ((1,), dict(max_slots=2, hbm_budget=0.8e9))]


@pytest.mark.parametrize("policy", registered_policies())
def test_gateway_matches_the_reference(zoos, predictors, policy):
    prefix = policy in ("maestro-aff", "maestro-prefix")
    # team prompts are named blocks of 52-148 tokens: a window that holds
    # them, so every stage runs
    specs = [(a, dict(k, prefix_cache=True, s_max=192) if prefix else k)
             for a, k in TWO_NODES]

    def jobs(side):
        trace = (side.tg.generate_team_trace(5, seed=4) if prefix
                 else side.tg.generate_trace(5, rate=2.0, seed=3))
        return side.cl.jobs_from_trace(trace, n_clusters=2, prompt_cap=8,
                                       gen_cap=8, seed=3)

    ref, port = _both(zoos, specs, jobs, policy=policy,
                      predictor=lambda side: predictors[side.port])
    m = port[1]
    assert m.finished_jobs == 5 and m.dropped_jobs == 0
    assert m.finished_stages == len(port[0].telemetry.events)
    assert {e.node_id for e in port[0].telemetry.events.values()} == {0, 1}
    if prefix:
        assert m.prefill_tokens_avoided > 0


def test_gateway_matches_the_reference_chunked_with_a_horizon(zoos,
                                                              predictors):
    specs = [(a, dict(k, prefill_chunk_tokens=4, decode_horizon=4))
             for a, k in TWO_NODES]

    def jobs(side):
        return side.cl.jobs_from_trace(
            side.tg.generate_trace(5, rate=2.0, seed=8), n_clusters=2,
            prompt_cap=12, gen_cap=12, seed=8)

    ref, port = _both(zoos, specs, jobs, policy="maestro",
                      predictor=lambda side: predictors[side.port])
    m = port[1]
    assert m.finished_jobs == 5
    assert m.engine_fused_steps > 0 and m.engine_horizon_steps > 0


# ------------------------------------ tests/test_gateway.py's scenarios
ONE = ("qwen3-8b",)


def _obs(side, invocation=0, prompt_len=32, src_cluster=0):
    return side.obs_cls(app=0, role=0, position=0.0,
                        invocation_idx=invocation, tools_available=0,
                        cot=False, prompt_len=prompt_len, model_id=0,
                        text="live gateway stage", src_cluster=src_cluster)


def _stage(side, sid, jid, deps, interactive, max_new=6, tokens=None):
    return side.cl.LiveStage(stage_id=sid, job_id=jid, deps=deps,
                             obs=_obs(side, invocation=sid % 8),
                             interactive=interactive,
                             tokens=tokens or [1, 2, 3, 4, 5, 6],
                             max_new=max_new)


def test_dag_order_matches_the_reference(zoos):
    def jobs(side):
        return [side.cl.LiveJob(job_id=0, app="t", interactive=True,
                                arrival_s=0.0, stages=[
                                    _stage(side, 0, 0, [], True),
                                    _stage(side, 1, 0, [0], True),
                                    _stage(side, 2, 0, [0], True),
                                    _stage(side, 3, 0, [1, 2], True)])]

    _, (gw, m, _) = _both(zoos, [((0,), dict(max_slots=2))] * 2, jobs, ONE,
                          predictor=StubPred(), policy="maestro")
    assert m.finished_jobs == 1 and m.finished_stages == 4
    ev = gw.telemetry.events
    assert ev[0].finish_t <= min(ev[1].dispatch_t, ev[2].dispatch_t)
    assert max(ev[1].finish_t, ev[2].finish_t) <= ev[3].dispatch_t


def test_oversized_prompt_truncation_matches_the_reference(zoos):
    def jobs(side):
        return [side.cl.LiveJob(0, "t", True, 0.0, [
            _stage(side, 0, 0, [], True, tokens=list(range(64))),
            _stage(side, 1, 0, [0], True)])]

    _, (gw, m, tok) = _both(zoos, [((0,), dict(max_slots=2, s_max=64))],
                            jobs, ONE, policy="fcfs")
    assert m.truncated_stages == 1 and m.finished_jobs == 1
    assert tok[0][1:] == ([], True) and len(tok[1][1]) >= 1


def test_admission_rejection_matches_the_reference(zoos):
    def jobs(side):
        return [side.cl.LiveJob(0, "t", True, 0.0, [
            _stage(side, 0, 0, [], True), _stage(side, 1, 0, [0], True)])]

    out = []
    for side in _sides(zoos):
        fleet = side.fleet([((0,), dict(hbm_budget=96e6, max_slots=2))], ONE)
        out.append(side.serve(
            fleet, jobs(side), predictor=StubPred(length=2_000_000.0),
            policy="maestro", cfg=side.gw.GatewayConfig(reject_limit=5),
            max_ticks=500))
    _assert_same(*out)
    gw, m, _ = out[1]
    assert m.admission_rejections > 0
    assert m.dropped_jobs == 1 and m.finished_jobs == 0
    assert gw.tick == out[0][0].tick < 500
    for sid in (0, 1):
        assert sid not in gw.ready_t and sid not in gw._queued


def test_boundary_preemption_matches_the_reference(zoos):
    def jobs(side):
        return [side.cl.LiveJob(0, "b", False, 0.0,
                                [_stage(side, 0, 0, [], False, max_new=40)]),
                side.cl.LiveJob(1, "i", True, 0.3,
                                [_stage(side, 1, 1, [], True, max_new=5)])]

    _, (gw, m, tok) = _both(zoos, [((0,), dict(max_slots=1))], jobs, ONE,
                            predictor=StubPred(), policy="maestro")
    assert m.preemptions >= 1 and m.finished_jobs == 2
    ev = gw.telemetry.events
    assert ev[1].finish_t < ev[0].finish_t and len(tok[0][1]) == 40


def test_cold_start_aware_routing_matches_the_reference(zoos):
    out = []
    for side in _sides(zoos):
        fleet = side.fleet([((0,), {}), ((0,), {})], ONE)
        fleet[1].activate(ONE[0])                  # warm node 1
        job = side.cl.LiveJob(0, "t", True, 0.0,
                              [_stage(side, 0, 0, [], True)])
        out.append(side.serve(fleet, [job], predictor=StubPred(),
                              policy="maestro"))
    _assert_same(*out)
    gw, m, _ = out[1]
    assert gw.telemetry.events[0].node_id == 1 and m.cold_starts == 0


# ------------------------------------------------------- the port alone
def test_worker_backend_over_an_inproc_fleet_is_refused(zoos):
    _, port = _sides(zoos)
    fleet = port.fleet([((0,), {})], ONE)
    for backend in ("process", "socket"):
        with pytest.raises(ValueError, match="requires worker"):
            gateway.ClusterGateway(
                fleet, RTT, policy="fcfs",
                cfg=gateway.GatewayConfig(node_backend=backend))
    # a worker builds its node on the card unless its spec names the CPU:
    # without one the fleet refuses to boot
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cluster.build_fleet(backend="process")


def test_wall_clock_run_finishes(zoos, predictors):
    _, port = _sides(zoos)
    fleet = port.fleet(TWO_NODES)
    jobs = cluster.jobs_from_trace(tg.generate_trace(2, rate=4.0, seed=1),
                                   n_clusters=2, prompt_cap=8, gen_cap=6,
                                   seed=1)
    gw, m, tok = port.serve(fleet, jobs, predictor=predictors[1],
                            policy="maestro",
                            cfg=gateway.GatewayConfig(clock="wall",
                                                      max_run_s=60.0))
    assert isinstance(gw.clock, WallClock)
    assert m.clock == "wall" and m.run_outcome == "completed"
    assert m.finished_jobs == 2 and m.dropped_jobs == 0
    assert len(tok) == sum(len(j.stages) for j in jobs)
    assert m.wall_makespan_s > 0 and m.ttft_p50_s > 0
    assert set(m.node_busy_frac) == {0, 1}


# ------------- a GPU tier that holds one model: the port's repair
PAIR = ("qwen3-8b", "mamba2-2.7b")


def _one_model_tier(fleet):
    """Shrink each node's GPU tier to hold either model but not both (the
    accountant's budget still holds both, as at full width under 24 GB)."""
    for node in fleet:
        node.residency.cap["gpu"] = max(node.residency.size(n)
                                        for n in PAIR) + 1
    return fleet


def test_a_one_model_tier_refuses_the_cold_model_instead_of_raising(zoos):
    """The reference's accountant admits a cold model the tier cannot load
    beside an in-flight one, and its submit raises; the port refuses it at
    admission and serves every job."""
    ref, port = _sides(zoos)

    def jobs(side):
        return side.cl.jobs_from_trace(
            side.tg.generate_trace(6, rate=4.0, seed=0), n_clusters=2,
            prompt_cap=8, gen_cap=16, seed=0)

    spec = [((0,), dict(max_slots=4))]
    with pytest.raises(RuntimeError, match="cannot activate"):
        ref.serve(_one_model_tier(ref.fleet(spec, PAIR)), jobs(ref),
                  policy="fcfs")
    gw, m, tok = port.serve(_one_model_tier(port.fleet(spec, PAIR)),
                            jobs(port), policy="fcfs")
    assert m.finished_jobs == 6 and m.dropped_jobs == 0
    assert m.admission_rejections > 0
    assert all(len(out) >= 1 for _, out, _ in tok.values())


def test_a_request_for_a_model_the_tier_cannot_take_waits_on_the_node(zoos):
    _, port = _sides(zoos)
    node = _one_model_tier(port.fleet([((0,), dict(max_slots=2))], PAIR))[0]
    solo = port.fleet([((0,), dict(max_slots=2))], PAIR)[0]
    q = Request(req_id=0, tokens=[5, 6, 7, 8, 9], max_new=6)
    node.submit(PAIR[0], q)
    node.step()                                    # qwen3 in flight
    assert not node.can_admit(1e5, PAIR[1])
    m = Request(req_id=1, tokens=[3, 1, 4, 1, 5], max_new=6)
    node.submit(PAIR[1], m)
    assert list(node.deferred[PAIR[1]]) == [m] and m.submit_s > 0
    assert PAIR[1] not in node.device_params
    # the node drains: it takes no more work, not even for qwen3
    assert not node.can_admit(1e5, PAIR[0])
    gone = Request(req_id=2, tokens=[2, 7, 1], max_new=4)
    node.submit(PAIR[1], gone)
    assert node.preempt(PAIR[1], 2) is gone
    done = {}
    while node.has_work():
        for reqs in node.step().values():
            done.update({r.req_id: r.out for r in reqs})
    assert sorted(done) == [0, 1] and not any(node.deferred.values())
    assert node.residency.state[PAIR[0]].value == "sleeping"
    for name, rid, toks in ((PAIR[0], 0, [5, 6, 7, 8, 9]),
                            (PAIR[1], 1, [3, 1, 4, 1, 5])):
        solo.submit(name, Request(req_id=rid, tokens=toks, max_new=6))
    want = {}
    while solo.has_work():
        for reqs in solo.step().values():
            want.update({r.req_id: r.out for r in reqs})
    assert done == want


def test_deferred_models_take_their_turns_on_a_one_model_tier(zoos):
    """Two models deferred behind an in-flight one, on a tier that holds
    one model: once the in-flight model drains the node activates the
    first and keeps the second waiting until the first drains in turn."""
    _, port = _sides(zoos)
    spec = [((0,), dict(max_slots=2))]
    node = port.fleet(spec)[0]
    sizes = sorted(node.residency.size(n) for n in ZOO)
    node.residency.cap["gpu"] = sizes[-1] + 1
    assert sizes[0] + sizes[1] > node.residency.cap["gpu"]
    solo = port.fleet(spec)[0]
    prompts = ([5, 6, 7, 8, 9], [3, 1, 4, 1, 5], [2, 7, 1, 8])
    node.submit(ZOO[0], Request(req_id=0, tokens=prompts[0], max_new=6))
    node.step()                                    # ZOO[0] in flight
    for rid in (1, 2):
        node.submit(ZOO[rid], Request(req_id=rid, tokens=prompts[rid],
                                      max_new=6))
    assert [m for m, q in node.deferred.items() if q] == list(ZOO[1:])
    done, resident = {}, []
    while node.has_work():
        for reqs in node.step().values():
            done.update({r.req_id: r.out for r in reqs})
        resident.append(sorted(node.device_params))
    assert all(len(r) <= 1 for r in resident)
    assert [(a.model, a.cause, a.req_ids) for a in node.activations] == [
        (ZOO[0], "submit", [0]), (ZOO[1], "deferred", [1]),
        (ZOO[2], "deferred", [2])]
    assert all(a.deferred_s > 0 for a in node.activations[1:])
    assert [o.model for o in node.offloads] == list(ZOO[:2])
    for rid, name in enumerate(ZOO):
        solo.submit(name, Request(req_id=rid, tokens=prompts[rid], max_new=6))
    want = {}
    while solo.has_work():
        for reqs in solo.step().values():
            want.update({r.req_id: r.out for r in reqs})
    assert done == want
