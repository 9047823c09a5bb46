"""The port's scheduling core against the JAX package's, on the CPU.

The trace generators, the length predictor, the SRTF queue, the fitness
router, the rho margin and the closed-loop controller are numpy in both
packages, so the tolerance is equality: the same seeds must give the same
fingerprints, predictions and decisions.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import control_loop as jax_cl
from repro.core.predictor import cost_model as jax_cm
from repro.core.predictor import length_model as jax_lm
from repro.core.predictor.gbdt import GBDTConfig as JaxGBDTConfig
from repro.core.sched import fitness as jax_fit
from repro.core.sched import margins as jax_margins
from repro.core.sched import policies as jax_policies
from repro.core.sched import srtf as jax_srtf
from repro.data import tracegen as jax_tg
from repro_torch.configs import get_config
from repro_torch.core import control_loop as cl
from repro_torch.core.predictor import cost_model as cm
from repro_torch.core.predictor import length_model as lm
from repro_torch.core.predictor.gbdt import GBDTConfig
from repro_torch.core.sched import fitness as fit
from repro_torch.core.sched import margins
from repro_torch.core.sched import policies
from repro_torch.core.sched import srtf
from repro_torch.core.topology import DEFAULT_RTT
from repro_torch.data import tracegen as tg

# tests/test_tracegen.py's golden fingerprints of the frozen generators
LEGACY_GOLDEN = {
    ("trace", 64, 0): "7b5d13aa608a24ddff804898334c9938",
    ("trace", 48, 13): "2a59de01bae5fba85d7522d8809b353d",
    ("team", 24, 0): "4b62ed5b23751f2da10bf93471f4d8b3",
    ("team", 16, 5): "837f9027ff527bb587e795c95b57183a",
}
LEGACY_CALLS = {
    ("trace", 64, 0): lambda m: m.generate_trace(64, seed=0),
    ("trace", 48, 13): lambda m: m.generate_trace(48, rate=2.0,
                                                  batch_ratio=0.6, seed=13),
    ("team", 24, 0): lambda m: m.generate_team_trace(24, seed=0),
    ("team", 16, 5): lambda m: m.generate_team_trace(16, seed=5, n_teams=2),
}
ZOO = ("qwen3-8b", "starcoder2-15b", "mamba2-2.7b")
# the reference's hardware values, so modelled seconds compare
REF_HW = cm.HardwareSpec(**dataclasses.asdict(jax_cm.HardwareSpec()))


# ------------------------------------------------------------- trace gen
@pytest.mark.parametrize("key", sorted(LEGACY_GOLDEN))
def test_legacy_generators_give_the_golden_fingerprints(key):
    jobs = LEGACY_CALLS[key](tg)
    assert tg.workload_fingerprint(jobs) == LEGACY_GOLDEN[key]
    assert tg.workload_fingerprint(jobs) == jax_tg.workload_fingerprint(
        LEGACY_CALLS[key](jax_tg))


def test_registries_match_the_reference():
    for name in ("ARRIVALS", "DEMANDS", "LENGTHS"):
        assert sorted(getattr(tg, name)) == sorted(getattr(jax_tg, name))
    assert tg.TAIL_SCENARIOS == jax_tg.TAIL_SCENARIOS
    assert tg.MODELS == jax_tg.MODELS


@pytest.mark.parametrize("arrival", sorted(jax_tg.ARRIVALS))
@pytest.mark.parametrize("demand", [None] + sorted(jax_tg.DEMANDS))
def test_workload_fingerprints_match_the_reference(arrival, demand):
    kw = dict(arrival=arrival, demand=demand, lengths="pareto", seed=7)
    assert tg.workload_fingerprint(tg.generate_workload(30, **kw)) == \
        jax_tg.workload_fingerprint(jax_tg.generate_workload(30, **kw))


@pytest.mark.parametrize("name", sorted(jax_tg.TAIL_SCENARIOS))
def test_scenario_presets_match_the_reference(name):
    a = tg.scenario_workload(name, 40, seed=3, rate_scale=0.5)
    b = jax_tg.scenario_workload(name, 40, seed=3, rate_scale=0.5)
    assert tg.workload_fingerprint(a) == jax_tg.workload_fingerprint(b)


# ------------------------------------------------------------- predictor
def _train(pkg_tg, pkg_lm, gbdt_cfg, n_jobs=120, seed=9):
    train, test = pkg_tg.stratified_temporal_split(
        pkg_tg.generate_trace(n_jobs, seed=seed))
    cfg = pkg_lm.PredictorConfig(
        cls=gbdt_cfg(objective="logloss", n_trees=12, max_leaves=7),
        reg=gbdt_cfg(n_trees=16, max_leaves=7))
    pred = pkg_lm.MaestroPred(cfg).fit(
        [s.obs for s in train],
        np.array([s.true_len for s in train], float),
        np.array([float(s.tool_call) for s in train]))
    return pred, test


@pytest.fixture(scope="module")
def predictors():
    return (_train(jax_tg, jax_lm, JaxGBDTConfig),
            _train(tg, lm, GBDTConfig))


def test_maestro_pred_predictions_match_the_reference(predictors):
    (jp, jtest), (pp, ptest) = predictors
    want = jp.predict([s.obs for s in jtest])
    got = pp.predict([s.obs for s in ptest])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12,
                                   err_msg=k)
    for js, ps in zip(jtest[:20], ptest[:20]):
        a, b = jp.predict_one(js.obs), pp.predict_one(ps.obs)
        assert b["length"] == pytest.approx(a["length"], abs=1e-12)
        assert b["p_tool"] == pytest.approx(a["p_tool"], abs=1e-12)


def _assert_same_predictions(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12,
                                   err_msg=k)


def test_length_baselines_match_the_reference():
    jtrain, jtest = jax_tg.stratified_temporal_split(
        jax_tg.generate_trace(80, seed=4))
    ptrain, ptest = tg.stratified_temporal_split(tg.generate_trace(80, seed=4))
    y = np.array([s.true_len for s in jtrain], float)
    a = jax_lm.LinearBaseline().fit([s.obs for s in jtrain], y)
    b = lm.LinearBaseline().fit([s.obs for s in ptrain], y)
    _assert_same_predictions(b.predict([s.obs for s in ptest]),
                             a.predict([s.obs for s in jtest]))
    a = jax_lm.MagnusBaseline(JaxGBDTConfig(n_trees=8, max_leaves=7)).fit(
        [s.obs for s in jtrain], y)
    b = lm.MagnusBaseline(GBDTConfig(n_trees=8, max_leaves=7)).fit(
        [s.obs for s in ptrain], y)
    _assert_same_predictions(b.predict([s.obs for s in ptest]),
                             a.predict([s.obs for s in jtest]))


# ------------------------------------------------- queue, router, margins
def _srtf_log(pkg_srtf):
    """One scripted sequence of pushes, pops, aging refreshes, removals
    and preemption questions; returns what the queue answered."""
    rng = np.random.default_rng(11)
    q = pkg_srtf.SRTFQueue(aging_factor=0.5, preempt_gain_s=1.0,
                           cooldown_s=3.0)
    live, log = [], []
    for t in range(240):
        now = t * 0.25
        op = int(rng.integers(6))
        s = pkg_srtf.QueuedStage(t, int(rng.integers(20)),
                                 bool(rng.random() < 0.3),
                                 float(rng.uniform(0, 10)),
                                 float(rng.uniform(0, 30)))
        gap = float(rng.uniform(0, 6))
        if op <= 1:
            q.push(s, now)
            live.append(s)
        elif op == 2:
            got = q.pop(now)
            if got is not None:
                live.remove(got)
            log.append(None if got is None else got.stage_id)
        elif op == 3:
            q.refresh(now)
            got = q.peek()
            log.append((len(q), None if got is None else got.stage_id))
        elif op == 4 and live:
            victim = live.pop(int(rng.integers(len(live))))
            q.remove(victim)
            log.append(("removed", victim.stage_id, len(q)))
        else:
            log.append(q.should_preempt(s, pkg_srtf.QueuedStage(
                -1, 99, bool(rng.random() < 0.6), gap / 2, 0.0), gap, now))
    return log


def test_srtf_queue_decides_as_the_reference():
    want = _srtf_log(jax_srtf)
    assert _srtf_log(srtf) == want
    answers = [x for x in want if isinstance(x, bool)]
    assert any(answers) and not all(answers)
    assert srtf.state_key(3, 2, 11, 0.6) == jax_srtf.state_key(3, 2, 11, 0.6)


def test_rho_estimator_matches_the_reference():
    rng = np.random.default_rng(2)
    a, b = jax_margins.RhoEstimator(), margins.RhoEstimator()
    for _ in range(300):
        actual, pred = float(rng.uniform(50, 150)), 100.0
        a.observe(actual, pred)
        b.observe(actual, pred)
        assert b.rho == a.rho
        assert b.r_need(1e6) == a.r_need(1e6)


def _signals(pkg_fit, rng, n=5):
    return [pkg_fit.NodeSignal(
        node_id=i, cluster_id=i % 3, headroom=float(h),
        queue_delay_s=float(q), warm_models=({"qwen3-8b": 0.0}
                                             if i % 2 else {}),
        supports_vmm=bool(i != 3), total_hbm=16e9,
        prefix_digests=tuple(f"d{k}" for k in range(i)))
        for i, (h, q) in enumerate(zip(rng.uniform(1e8, 3e9, n),
                                       rng.uniform(0, 2, n)))]


def test_fitness_router_selects_as_the_reference():
    w = dict(w_prefix=0.5)
    routers = [(jax_fit, jax_fit.FitnessRouter(
        DEFAULT_RTT, jax_fit.FitnessWeights(**w))),
        (fit, fit.FitnessRouter(DEFAULT_RTT, fit.FitnessWeights(**w)))]
    picks = [[], []]
    for k, (pkg, router) in enumerate(routers):
        rng = np.random.default_rng(8)
        for sid in range(80):
            nodes = _signals(pkg, rng)
            req = pkg.StageRequest(
                stage_id=sid, model=("qwen3-8b", "mamba2-2.7b")[sid % 2],
                r_need=float(rng.uniform(5e7, 2.5e9)),
                interactive=bool(sid % 3 == 0), src_cluster=sid % 3,
                t_exec=float(rng.uniform(0.1, 3)),
                high_concurrency=bool(sid % 5 == 0),
                prefix_digests=tuple(f"d{k}" for k in range(sid % 4)))
            sel = router.select(
                req, nodes,
                lambda s, m: 0.0 if m in s.warm_models else 1.7,
                lambda s, r: None if s.node_id == 4 else 0.3 * s.node_id)
            picks[k].append(None if sel is None else (sel[0].node_id, sel[1]))
    assert picks[0] == picks[1]
    assert len({p[0] for p in picks[0] if p is not None}) > 1


def test_maestro_controller_plans_as_the_reference(predictors):
    (jp, _), (pp, _) = predictors
    jprof = {n: jax_cm.profile_from_arch(
        __import__("repro.configs", fromlist=["get_config"]).get_config(n),
        jax_cm.HardwareSpec()) for n in ZOO}
    pprof = {n: cm.profile_from_arch(get_config(n), REF_HW) for n in ZOO}
    sides = [(jax_cl, jax_fit, jax_tg,
              jax_cl.MaestroController(jp, jprof, DEFAULT_RTT)),
             (cl, fit, tg, cl.MaestroController(pp, pprof, DEFAULT_RTT))]
    logs = [[], []]
    for k, (pkg_cl, pkg_fit, pkg_tg, ctl) in enumerate(sides):
        rng = np.random.default_rng(6)
        stages = pkg_tg.flatten_stages(pkg_tg.generate_trace(10, seed=21))
        plans = []
        for i, s in enumerate(stages):
            nodes = _signals(pkg_fit, rng)
            plan = ctl.plan(s.stage_id, s.job_id, s.obs, s.interactive,
                            nodes, lambda n, m: 0.0 if m in n.warm_models
                            else 1.5, lambda n, r: 0.2 * n.node_id,
                            now=float(i))
            ctl.enqueue(plan, s.job_id, s.interactive, float(i))
            plans.append((s, plan))
            logs[k].append((pkg_cl.model_name(s.obs, ctl.profiles),
                            dataclasses.astuple(plan)))
            if i % 3 == 2:
                done_s, done = plans.pop(0)
                ctl.observe_completion(done_s.obs, done, done_s.true_len,
                                       done.r_kv_hat * 1.1, float(i) / 2)
        while len(ctl.queue):
            logs[k].append(ctl.queue.pop(99.0).stage_id)
        logs[k].append(ctl.rho.rho)
    assert logs[0] == logs[1]


def test_policy_registry_matches_the_reference():
    assert policies.registered_policies() == \
        jax_policies.registered_policies()
    for name in policies.registered_policies():
        a, b = jax_policies.POLICIES[name], policies.POLICIES[name]
        assert (b.name, b.needs_predictor, b.doc) == \
            (a.name, a.needs_predictor, a.doc)
        if not a.needs_predictor:
            pa, pb = jax_policies.make_policy(name), policies.make_policy(name)
            assert (pb.name, pb.requeue_at_boundary) == \
                (pa.name, pa.requeue_at_boundary)
    with pytest.raises(ValueError, match="unknown policy"):
        policies.make_policy("no-such-policy")
