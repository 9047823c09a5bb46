"""The port's node runtime, residency and degradation models and inproc
fleet against the JAX package's, on the CPU.

The residency manager, Algorithm 2 and the analytic profiles are held
against the reference's on the same hardware values. Two ``NodeRuntime``s
— the reference's and the port's (``device="cpu"``) — serve the reduced
default zoo from the same converted weights through one scripted sequence
of submits, steps, sleeps, reactivations and ``make_room`` calls; after
each stage their tokens, residency states, accountant registrations,
``kv_stats()`` (all but the reference's count of jit compiles: the port
compiles nothing and reports 0), ``signal()`` (all but the activation-time
estimates, which are modelled from the hardware spec and compared
separately) and the admission answers ``can_admit`` / ``degradation_cost``
must be equal.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import topology as jax_topology
from repro.core.predictor import cost_model as jax_cm
from repro.core.runtime import coordination as jax_coord
from repro.core.runtime import residency as jax_res
from repro.models import build_model as jax_build
from repro.serving.engine import Request as JaxRequest
from repro.serving.node_runtime import NodeRuntime as JaxNode
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import topology
from repro_torch.core.predictor import cost_model as cm
from repro_torch.core.runtime import coordination as coord
from repro_torch.core.runtime import residency as res
from repro_torch.core.sched.fitness import NodeSignal
from repro_torch.models import build_model
from repro_torch.models.transformer import Model
from repro_torch.serving import cluster
from repro_torch.serving.engine import Request
from repro_torch.serving.node_runtime import NodeRuntime


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch intra-op thread: test processes that each spin a pool of
    threads on a shared host slow one another down a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ZOO = cluster.DEFAULT_ZOO
# the reference's hardware values, so the modelled seconds compare
REF_HW = cm.HardwareSpec(**dataclasses.asdict(jax_cm.HardwareSpec()))


def _profiles(pkg_cm, get_cfg, hw):
    return {n: pkg_cm.profile_from_arch(get_cfg(n), hw) for n in ZOO}


def test_profiles_match_the_reference_and_default_to_the_h100():
    jp = _profiles(jax_cm, jax_config, jax_cm.HardwareSpec())
    pp = _profiles(cm, get_config, REF_HW)
    for n in ZOO:
        a, b = dataclasses.asdict(jp[n]), dataclasses.asdict(pp[n])
        a.pop("hw"), b.pop("hw")
        assert a == b, n
        assert jp[n].t_exec(300, 50.0) == pytest.approx(
            pp[n].t_exec(300, 50.0), rel=1e-12)
        assert jp[n].r_kv(300, 50.0) == pp[n].r_kv(300, 50.0)
    hw = cm.HardwareSpec()
    assert (hw.peak_flops, hw.hbm_bw, hw.hbm_capacity) == (989e12, 3.35e12,
                                                           80e9)
    assert np.array_equal(topology.DEFAULT_RTT, jax_topology.DEFAULT_RTT)
    assert np.array_equal(topology.HYBRID_RTT, jax_topology.HYBRID_RTT)
    assert [f.name for f in dataclasses.fields(NodeSignal)] == [
        f.name for f in dataclasses.fields(
            __import__("repro.core.sched.fitness",
                       fromlist=["NodeSignal"]).NodeSignal)]


def _residency_trace(pkg_res, profiles):
    """Algorithm 1 under a GPU tier that holds about two of the three
    models: loads, LRU evictions to host, sleep, context demotion, pins."""
    sizes = sorted(p.weight_bytes for p in profiles.values())
    r = pkg_res.HierarchicalResidency(profiles, c_gpu=sizes[1] + sizes[2],
                                      c_cpu=sizes[2] * 2, c_disk=1e12)
    trace = []
    for step in ("qwen3-8b", "mamba2-2.7b", "starcoder2-15b", "qwen3-8b",
                 "sleep:starcoder2-15b", "demote:starcoder2-15b",
                 "pin:qwen3-8b", "mamba2-2.7b", "starcoder2-15b"):
        if step.startswith("sleep:"):
            r.sleep(step[6:])
        elif step.startswith("demote:"):
            r.demote_context(step[7:])
        elif step.startswith("pin:"):
            r.pinned = {step[4:]}
        else:
            trace.append(r.ensure_gpu(step))
        trace.append(({m: s.value for m, s in r.state.items()},
                      {m: r.activation_latency(m) for m in profiles},
                      r.warm_set(), [(e.kind, e.model, e.tier, e.seconds)
                                     for e in r.events], list(r.lru["gpu"])))
    return trace


def _repair_reference_fault(entry):
    """The reference marks a model whose host copy was evicted DISK / REMOTE
    even while it stays in the GPU tier; the port keeps it RUNNING (ROADMAP.md
    §3, repaired reference faults). Apply that repair to one entry of the
    reference's trace: such a model reads RUNNING, activates in 0 s and is in
    the warm set."""
    if not isinstance(entry, tuple) or len(entry) != 5:
        return entry
    state, latency, _, events, gpu = entry
    state, latency = dict(state), dict(latency)
    for m in gpu:
        if state[m] in ("disk", "remote"):
            state[m], latency[m] = "running", 0.0
    warm = [m for m, s in state.items() if s in ("running", "sleeping")]
    return state, latency, warm, events, gpu


def test_residency_matches_the_reference():
    jt = _residency_trace(jax_res, _profiles(jax_cm, jax_config,
                                             jax_cm.HardwareSpec()))
    pt = _residency_trace(res, _profiles(cm, get_config, REF_HW))
    repaired = [_repair_reference_fault(e) for e in jt]
    assert repaired != jt      # this trace reaches the reference's fault
    assert pt == repaired
    assert res.RETRACE_COST_S == jax_res.RETRACE_COST_S


def test_residency_keeps_a_resident_model_running_when_its_host_copy_goes():
    """The repaired reference fault: making host room for m0 drops m4's host
    copy while m4 is still on the card. The reference then marks m4 DISK and
    refuses to activate it; the port keeps it RUNNING, and drops its disk
    copy once m4 goes back to the host."""
    def run(pkg_cm, pkg_res):
        profiles = {f"m{i}": pkg_cm.synthetic_profile(f"m{i}", params_b=0.5 + i)
                    for i in range(6)}
        r = pkg_res.HierarchicalResidency(profiles, c_gpu=12e9, c_cpu=20e9,
                                          c_disk=60e9)
        for m in ("m5", "m4", "m5", "m4", "m0"):
            assert r.ensure_gpu(m)[0], m
        return r, r.ensure_gpu("m4")

    r, (ok, t_act) = run(cm, res)
    assert ok and t_act == 0.0
    assert r.lru["gpu"] and all(r.state[m] is res.ModelState.RUNNING
                                for m in r.lru["gpu"])
    assert r.used("cpu") <= r.cap["cpu"] and r.used("gpu") <= r.cap["gpu"]
    # m5 sends m4 back to the host: its disk copy goes, so that no model is
    # in both the host and the disk tier
    assert r.ensure_gpu("m5")[0]
    assert r.state["m4"] is res.ModelState.SLEEPING
    assert not set(r.lru["cpu"]) & set(r.lru["disk"])
    assert r.used("disk") <= r.cap["disk"]
    _, (jax_ok, _) = run(jax_cm, jax_res)
    assert not jax_ok


@pytest.mark.parametrize("required", [1e9, 2e10, 5e10, 1e13])
def test_plan_degradation_matches_the_reference(required):
    def engines(pkg):
        S = pkg.EngineState
        return [pkg.EngineInfo("a", S.ACTIVE, 16e9, 2e8, 3e9, 4000, 80.0),
                pkg.EngineInfo("b", S.IDLE, 5e9, 2e8),
                pkg.EngineInfo("c", S.SLEEPING, 3e10, 4e8),
                pkg.EngineInfo("d", S.PENDING_SLEEP, 7e9, 1e8),
                pkg.EngineInfo("e", S.ACTIVE, 9e9, 1e8)]
    want = jax_coord.plan_degradation(required, engines(jax_coord),
                                      jax_cm.HardwareSpec())
    got = coord.plan_degradation(required, engines(coord), REF_HW)
    if want is None:
        assert got is None
        return
    assert (got.freed, got.interrupts_active, got.c_deg) == (
        want.freed, want.interrupts_active, want.c_deg)
    assert [(e.model, a.value) for e, a in got.steps] == \
        [(e.model, a.value) for e, a in want.steps]


# ------------------------------------------------------------ node parity
@pytest.fixture(scope="module")
def zoos():
    jzoo, jhost, host = {}, {}, {}
    for i, name in enumerate(ZOO):
        jm = jax_build(jax_config(name).reduced())
        jzoo[name] = jm
        jhost[name] = jax.tree.map(np.asarray,
                                   jm.init(jax.random.PRNGKey(1 + i)))
        host[name] = params_from_jax(jhost[name],
                                     get_config(name).reduced(), "cpu")
    return jzoo, jhost, host


NODE_KW = dict(hbm_budget=1e9, max_slots=2, s_max=48, prefix_cache=True,
               decode_horizon=4, prefill_chunk_tokens=0)


def _nodes(zoos, **kw):
    jzoo, jhost, host = zoos
    kw = {**NODE_KW, **kw}
    jnode = JaxNode(0, 1, jzoo, jhost, **kw)
    own = {n: build_model(get_config(n).reduced(), host[n], device="cpu")
           for n in ZOO}
    pnode = NodeRuntime(0, 1, own, host, device="cpu", **kw)
    # the port's node models an H100; the residency and degradation models
    # are compared on the reference's hardware values
    for n, prof in pnode.profiles.items():
        pnode.profiles[n] = dataclasses.replace(prof, hw=REF_HW)
    pnode.residency.hw = REF_HW
    return jnode, pnode


def _state(node):
    sig = node.signal()
    # requests that fit, that fit after sleeping an idle model, after also
    # dropping warm contexts, and that never fit
    h = node.acc.headroom
    probes = [1e5, h + 1e6, h + 9e6, h + 5e8]
    kv_stats = node.kv_stats()
    kv_stats.pop("engine_prefill_compiles")
    return dict(
        residency={m: s.value for m, s in node.residency.state.items()},
        events=[(e.kind, e.model, e.tier, e.seconds)
                for e in node.residency.events],
        weights=dict(node.acc.weights), ctx=dict(node.acc.ctx),
        m_kv=node.acc.m_kv, resident=sorted(node.device_params),
        kv_stats=kv_stats,
        signal=(sig.node_id, sig.cluster_id, sig.headroom,
                sig.queue_delay_s, sorted(sig.warm_models), sig.total_hbm,
                sig.prefix_digests),
        t_act={m: node.t_act(m) for m in ZOO},
        can_admit=[node.can_admit(r, m) for r in probes
                   for m in (None,) + ZOO],
        degradation_cost=[node.degradation_cost(r) for r in probes])


def _run(node, req_cls, model, prompts, rid0, max_new=6, steps=None):
    for i, p in enumerate(prompts):
        node.submit(model, req_cls(req_id=rid0 + i, tokens=list(p),
                                   max_new=max_new))
    out, n = {}, 0
    while node.has_work() and (steps is None or n < steps):
        for reqs in node.step().values():
            out.update({r.req_id: r.out for r in reqs})
        n += 1
    return out


@pytest.mark.parametrize("chunk", [0, 8])
def test_node_runtime_matches_the_reference(zoos, chunk):
    jnode, pnode = _nodes(zoos, prefill_chunk_tokens=chunk)
    rng = np.random.default_rng(4)
    base = [int(t) for t in rng.integers(0, 512, 40)]
    # cold activation, then a shared-prefix workflow: each stage drained
    # before the next, so later stages hit the earlier stages' pages
    assert pnode.activate("qwen3-8b") >= 0 and jnode.activate("qwen3-8b") >= 0
    assert _state(pnode) == _state(jnode)
    stages = [base, base[:32] + [3, 1, 4], base[:20] + [7] * 9]
    for i, p in enumerate(stages):
        assert _run(pnode, Request, "qwen3-8b", [p], i) == \
            _run(jnode, JaxRequest, "qwen3-8b", [p], i)
    assert pnode.kv_stats()["prefix_tokens_avoided"] == 52
    got = _state(pnode)
    assert got == _state(jnode)
    assert got["degradation_cost"][1] > 0.0 and \
        got["degradation_cost"][3] is None
    # co-location: starcoder2 and mamba2 join; mamba2 sleeps mid-request
    # and its requeued request finishes after a self-healing reactivation
    assert _run(pnode, Request, "starcoder2-15b", [base[:12], base[5:30]],
                10) == _run(jnode, JaxRequest, "starcoder2-15b",
                            [base[:12], base[5:30]], 10)
    for node, req_cls in ((pnode, Request), (jnode, JaxRequest)):
        _run(node, req_cls, "mamba2-2.7b", [base[:9]], 20, steps=2)
        node.sleep("mamba2-2.7b")
    assert _state(pnode) == _state(jnode)
    assert pnode.engines["mamba2-2.7b"].waiting
    assert _run(pnode, Request, "mamba2-2.7b", [], 0) == \
        _run(jnode, JaxRequest, "mamba2-2.7b", [], 0)
    assert _state(pnode) == _state(jnode)
    # level 0 first: a request that fits once some prefix pins go
    need = pnode.acc.headroom + pnode.acc.ctx["prefix-cache"] / 2
    for node in (pnode, jnode):
        node.make_room(need)
    assert pnode.kv_stats()["prefix_evictions"] > 0
    assert all(s == res.ModelState.RUNNING
               for s in pnode.residency.state.values())
    assert _state(pnode) == _state(jnode)
    # level 1: room for a large request sleeps idle engines
    need = pnode.acc.headroom + 2.5e6
    for node in (pnode, jnode):
        node.make_room(need)
    assert res.ModelState.SLEEPING in pnode.residency.state.values()
    assert _state(pnode) == _state(jnode)
    # warm reactivation of every slept model, then the first stage again
    for node in (pnode, jnode):
        node.sleep("qwen3-8b")
    assert _run(pnode, Request, "qwen3-8b", [base], 30) == \
        _run(jnode, JaxRequest, "qwen3-8b", [base], 30)
    assert _state(pnode) == _state(jnode)
    assert pnode.arena.check_mirror()
    assert pnode.kv_stats()["engine_prefill_compiles"] == 0


def test_offload_drops_the_weights_and_activation_restores_them(zoos):
    _, pnode = _nodes(zoos)
    host = pnode.host_params["qwen3-8b"]
    model = pnode.zoo["qwen3-8b"]
    # every model starts in host memory: nothing of it on the device
    assert all(p.numel() == 0 for p in model.parameters())
    pnode.activate("qwen3-8b")
    eng = pnode.engines["qwen3-8b"]
    for n, p in model.named_parameters():
        assert torch.equal(p, host[n]) and p.data_ptr() != host[n].data_ptr()
    assert pnode.acc.weights["qwen3-8b"] == sum(t.nbytes
                                                for t in host.values())
    pnode.sleep("qwen3-8b")
    assert all(p.numel() == 0 for p in model.parameters())
    assert "qwen3-8b" not in pnode.acc.weights
    pnode.activate("qwen3-8b")
    assert pnode.engines["qwen3-8b"] is eng and eng.model is model
    assert all(torch.equal(p, host[n]) for n, p in model.named_parameters())


@pytest.mark.parametrize("name", ZOO)
def test_param_tree_rebuilds_the_model_over_the_same_tensors(name):
    model = build_model(get_config(name).reduced(), device="cpu", seed=0)
    twin = Model(model.cfg, model.param_tree())
    a, b = dict(model.named_parameters()), dict(twin.named_parameters())
    assert a.keys() == b.keys()
    assert all(a[k].data_ptr() == b[k].data_ptr() for k in a)


def test_build_fleet_inproc_over_the_default_zoo():
    spec = cluster.ClusterSpec()
    fleet = cluster.build_fleet(spec, device="cpu")
    assert [n.node_id for n in fleet] == [0, 1, 2]
    assert [n.cluster_id for n in fleet] == [0, 0, 1]
    assert spec.n_clusters == 2
    assert fleet[1].acc.m_total == 0.8e9
    # each node serves Models of its own over one shared host registry
    assert fleet[0].zoo["qwen3-8b"] is not fleet[1].zoo["qwen3-8b"]
    assert fleet[0].host_params["qwen3-8b"]["embedding"].data_ptr() == \
        fleet[1].host_params["qwen3-8b"]["embedding"].data_ptr()
    outs = []
    for node in fleet[:2]:
        outs.append(_run(node, Request, "qwen3-8b", [[5, 6, 7, 8]], 0))
    fleet[0].sleep("qwen3-8b")                  # must not touch node 1
    outs.append(_run(fleet[1], Request, "qwen3-8b", [[5, 6, 7, 8]], 0))
    assert outs[0] == outs[1] == outs[2] and len(outs[0][0]) == 6
    # the worker backends build the same nodes from these specs
    specs = cluster.worker_specs(spec, device="cpu")
    assert [(s.node_id, s.cluster_id, s.hbm_budget) for s in specs] == \
        [(n.node_id, n.cluster_id, n.acc.m_total) for n in fleet]
    assert all(s.device == "cpu" and s.reduced
               and s.model_names == tuple(spec.model_names) for s in specs)
