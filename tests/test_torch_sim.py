"""The port's trace-driven simulator against the JAX package's, on the CPU.

Both simulators are numpy over the same generated trace (the trace
generators' fingerprints are already equal, ``test_torch_sched.py``), so
the tolerance is equality: ``SimResult.row()`` (SLO attainment, latencies,
queue delay, finished jobs, cold starts, preemptions) for every registered
policy. ``SimNode`` builds its residency on ``HardwareSpec()``, whose
default differs between the packages (the reference's original
accelerator against one H100), so the port's is replaced here by the
reference's values; ``default_profiles`` passes its A100 spec explicitly.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _stubs import StubPred
from repro.core.predictor import cost_model as jax_cm
from repro.core.predictor import length_model as jax_lm
from repro.core.predictor.gbdt import GBDTConfig as JaxGBDTConfig
from repro.core.sched import policies as jax_policies
from repro.data import tracegen as jax_tg
from repro.sim import simulator as jax_sim
from repro_torch.core.predictor import cost_model as cm
from repro_torch.core.predictor import length_model as lm
from repro_torch.core.predictor.features import StageObservation
from repro_torch.core.predictor.gbdt import GBDTConfig
from repro_torch.core.sched import policies
from repro_torch.data import tracegen as tg
from repro_torch.data.tracegen import JobRecord, StageRecord
from repro_torch.serving.cluster import (ClusterSpec, LiveJob, LiveStage,
                                         NodeSpec, build_fleet, build_zoo)
from repro_torch.serving.gateway import ClusterGateway, GatewayConfig
from repro_torch.sim import cluster as sim_cluster
from repro_torch.sim import simulator as sim
from repro_torch.sim.simulator import SimConfig, Simulator

@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for the torch fleet of the live-parity case: on
    a shared host, processes that each spin a pool of threads slow one
    another down a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the contention regime of tests/test_sim.py's maestro-vs-fcfs case
CONTENDED = dict(nodes_per_cluster=(2, 1, 1))


@pytest.fixture
def reference_hw(monkeypatch):
    """The port's SimNode builds its residency on the reference's default
    HardwareSpec."""
    ref = dataclasses.asdict(jax_cm.HardwareSpec())
    monkeypatch.setattr(sim_cluster, "HardwareSpec",
                        lambda: cm.HardwareSpec(**ref))


def _run(pkg_sim, pkg_tg, policy, cfg_kw, n_jobs=120, seed=7):
    jobs = pkg_tg.generate_trace(n_jobs, rate=2.5, seed=seed,
                                 batch_ratio=0.6)
    s = pkg_sim.Simulator(jobs, policy, pkg_sim.SimConfig(**cfg_kw))
    return s.run(), s


def _stub():
    return StubPred(length=lambda obs: 40.0 + 3.0 * (obs.prompt_len % 101),
                    p_tool=0.25)


@pytest.mark.parametrize("name", policies.registered_policies())
def test_every_policy_equals_the_reference(reference_hw, name):
    assert name in jax_policies.registered_policies()
    pred = _stub() if policies.POLICIES[name].needs_predictor else None
    got, port = _run(sim, tg, policies.make_policy(name, predictor=pred),
                     CONTENDED)
    want, ref = _run(jax_sim, jax_tg,
                     jax_policies.make_policy(name, predictor=pred),
                     CONTENDED)
    assert got.row() == want.row()
    assert got.finished_jobs == 120
    assert port.stage_wait == ref.stage_wait
    assert port.job_finish == ref.job_finish


def _trained(pkg_tg, pkg_lm, gbdt_cfg):
    train, _ = pkg_tg.stratified_temporal_split(
        pkg_tg.generate_trace(250, rate=1.0, seed=4))
    cfg = pkg_lm.PredictorConfig(
        cls=gbdt_cfg(objective="logloss", n_trees=25, max_leaves=7),
        reg=gbdt_cfg(n_trees=30, max_leaves=15))
    return pkg_lm.MaestroPred(cfg).fit(
        [s.obs for s in train], np.array([s.true_len for s in train], float),
        np.array([float(s.tool_call) for s in train]))


@pytest.fixture(scope="module")
def trained():
    """Each package's MaestroPred, trained as tests/test_sim.py trains it."""
    return (_trained(tg, lm, GBDTConfig),
            _trained(jax_tg, jax_lm, JaxGBDTConfig))


@pytest.mark.parametrize("cfg_kw", [{}, CONTENDED],
                         ids=["default", "contended"])
def test_maestro_with_trained_predictors_equals_the_reference(reference_hw,
                                                              trained,
                                                              cfg_kw):
    got, port = _run(sim, tg, policies.Maestro(trained[0]), cfg_kw)
    want, _ = _run(jax_sim, jax_tg, jax_policies.Maestro(trained[1]),
                   cfg_kw)
    assert got.row() == want.row()
    assert got.finished_jobs == 120
    for n in port.nodes:
        assert n.acc.check_invariant()
        assert not n.running            # all released


def test_the_hardware_default_is_the_ports_own():
    """Without the replacement the port's nodes model one H100."""
    s = Simulator(tg.generate_trace(4, seed=1), "fcfs")
    assert s.nodes[0].hw == cm.HardwareSpec()
    assert s.nodes[0].hw.name == "h100-sxm5-80g"


def test_profiles_equal_the_reference():
    want = jax_sim.default_profiles()
    got = sim.default_profiles()
    assert list(got) == list(want)
    for name in want:
        assert dataclasses.asdict(got[name]) == dataclasses.asdict(
            want[name])
    assert dataclasses.asdict(cm.A100_40G) == dataclasses.asdict(
        jax_cm.A100_40G)
    ref_hw = jax_cm.HardwareSpec()
    port_hw = cm.HardwareSpec(**dataclasses.asdict(ref_hw))
    for args in (("q", 0.6), ("q", 14.0, 48, 4, 64, 1 << 20)):
        assert dataclasses.asdict(cm.synthetic_profile(
            *args[:2], port_hw, *args[2:])) == dataclasses.asdict(
                jax_cm.synthetic_profile(*args[:2], ref_hw, *args[2:]))


# -------------------------------------------- sim/live decision parity
RTT = np.array([[0.001, 0.08], [0.08, 0.001]])
ZOO = ("qwen3-8b",)
# stage_id -> prompt_len; the stub predicts prompt_len / 4, distinct and
# below the live decode budget of 16 for the real stages
LENS = {0: 12, 1: 36, 2: 60}
GIANT_PROMPT = 4_000_000              # l_hat 1e6 -> R_need >> any node


def _obs(sid, prompt_len):
    return StageObservation(app=0, role=0, position=0.0, invocation_idx=sid,
                            tools_available=0, cot=False,
                            prompt_len=prompt_len, model_id=0,
                            text="parity stage", src_cluster=0)


def _record(policy, log):
    """Wrap policy.route to record (stage_id, decision)."""
    cls_route = type(policy).route

    def route(sub, stage, r_need):
        nid = cls_route(policy, sub, stage, r_need)
        log.append((stage.stage_id, nid))
        return nid

    policy.route = route
    return policy


def test_one_maestro_instance_decides_alike_in_sim_and_live():
    """The port's counterpart of tests/test_policies.py's
    test_sim_live_parity_maestro: one policy object over the port's
    Simulator and the port's gateway on a torch fleet, node 0 the only
    feasible node and single-slot contention: the same dispatch order, the
    same routes, and the oversized job refused on both planes."""
    pol = policies.Maestro(StubPred(length=lambda obs: obs.prompt_len / 4))
    sim_jobs, live_jobs = [], []
    for sid, plen in {**LENS, 3: GIANT_PROMPT}.items():
        sim_jobs.append(JobRecord(
            job_id=sid, app="parity", interactive=True, arrival_s=0.0,
            stages=[StageRecord(job_id=sid, stage_id=sid, deps=[],
                                obs=_obs(sid, plen), interactive=True,
                                true_len=max(plen // 4, 1),
                                tool_call=False)]))
        live_jobs.append(LiveJob(
            job_id=sid, app="parity", interactive=True, arrival_s=0.0,
            stages=[LiveStage(stage_id=sid, job_id=sid, deps=[],
                              obs=_obs(sid, plen), interactive=True,
                              tokens=[1, 2, 3, 4, 5, 6], max_new=16)]))

    sim_log = []
    s = Simulator(sim_jobs, _record(pol, sim_log),
                  SimConfig(nodes_per_cluster=(1, 1), max_concurrency=1),
                  rtt=RTT)
    s.nodes[1].acc.m_total = 1e9       # weights floor alone exceeds this
    r_sim = s.run()

    zoo, host = build_zoo(ZOO, seed=1)
    fleet = build_fleet(ClusterSpec(
        nodes=(NodeSpec(0, max_slots=1, hbm_budget=1.2e9),
               NodeSpec(1, max_slots=1, hbm_budget=20e6)),
        rtt_s=RTT, model_names=ZOO), zoo=zoo, host=host, device="cpu")
    live_log = []
    gw = ClusterGateway(fleet, RTT, policy=_record(pol, live_log),
                        cfg=GatewayConfig(reject_limit=500))
    m_live = gw.run(live_jobs)

    assert r_sim.finished_jobs == 3
    assert m_live.finished_jobs == 3
    assert m_live.dropped_jobs == 1
    assert m_live.admission_rejections > 0

    def dispatched(log):
        return [(sid, nid) for sid, nid in log if nid is not None]

    assert dispatched(sim_log) == dispatched(live_log) == [(0, 0), (1, 0),
                                                           (2, 0)]
    assert (3, None) in sim_log and (3, None) in live_log
    for log in (sim_log, live_log):
        assert all(nid is None for sid, nid in log if sid == 3)
