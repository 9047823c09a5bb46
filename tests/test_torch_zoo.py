"""The port's config zoo and its last dense configs against the JAX package.

Every config the port registers (all ten of the reference's) equals the
reference's of the same name, field by field, in ``param_count``,
``active_param_count``, ``kv_bytes_per_token``, ``ssm_state_bytes``,
``layer_pattern_period`` and ``is_cross_layer``, and so does its
``reduced()`` variant. The reduced qwen3-32b and
qwen1.5-110b take the JAX model's weights through ``params_from_jax`` (for
qwen1.5, with the same random non-zero q/k/v biases set on both sides: the
reference initialises them to zero, which would leave the bias branch
untested): prefill, one chunk and one paged decode step give the
reference's float32 logits to 1e-4 and its planes to 1e-5, and the
engines' greedy tokens are identical, monolithic and chunked, at horizons
1 and 4. Last, one virtual-clock gateway run over a reduced zoo of
qwen3-8b, moonshot-v1-16b-a3b and jamba-v0.1-52b on two nodes equals the
JAX gateway's per stage (node, tokens, times) and in ``GatewayMetrics``
but ``engine_prefill_compiles`` and the TTFT percentiles.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _stubs import StubPred
from repro.configs import get_config as jax_config
from repro.configs.base import list_configs as jax_list_configs
from repro.core.predictor import cost_model as jax_cm
from repro.core.runtime.accounting import MemoryAccountant as JaxAccountant
from repro.data import tracegen as jax_tg
from repro.kernels import ref as jref
from repro.models import build_model as jax_build
from repro.serving import cluster as jax_cluster
from repro.serving import gateway as jax_gateway
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch.configs import base as config_base
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.predictor import cost_model as cm
from repro_torch.core.runtime.accounting import MemoryAccountant
from repro_torch.data import tracegen as tg
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.serving import cluster, gateway
from repro_torch.serving.engine import Engine, Request


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch intra-op thread: test processes that each spin a pool of
    threads on a shared host slow one another down a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _registered():
    for m in config_base._ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
    return sorted(config_base._REGISTRY)


NAMES = _registered()
DENSE = ("qwen3-32b", "qwen1.5-110b")
TOL = dict(rtol=0, atol=1e-5)
LOGIT_TOL = dict(rtol=0, atol=1e-4)
PAGE, ROWS, C = 4, 12, 6


def _close(got, exp, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(exp),
                               **(tol or TOL))


def _fields(c):
    return {f.name: (dataclasses.asdict(v) if dataclasses.is_dataclass(v)
                     else v)
            for f in dataclasses.fields(c)
            if f.name != "dtype" and (v := getattr(c, f.name)) is not None}


def test_the_port_registers_the_decoder_zoo():
    assert NAMES == sorted([
        "jamba-v0.1-52b", "llama-3.2-vision-11b", "llama4-scout-17b-a16e",
        "mamba2-2.7b", "moonshot-v1-16b-a3b", "qwen1.5-110b", "qwen3-32b",
        "qwen3-8b", "starcoder2-15b", "whisper-medium"])
    assert NAMES == jax_list_configs()


@pytest.mark.parametrize("name", NAMES)
def test_config_matches_reference(name):
    for c, j in ((get_config(name), jax_config(name)),
                 (get_config(name).reduced(), jax_config(name).reduced())):
        assert _fields(c) == {k: v for k, v in _fields(j).items()
                              if k in _fields(c)}
        assert {f.name for f in dataclasses.fields(c)} >= {
            k for k, v in _fields(j).items() if v is not None}
        for attr in ("param_count", "active_param_count",
                     "kv_bytes_per_token", "ssm_state_bytes"):
            assert getattr(c, attr)() == getattr(j, attr)(), attr
        assert c.layer_pattern_period == j.layer_pattern_period
        assert c.n_attn_layers == j.n_attn_layers
        assert [c.is_moe_layer(i) for i in range(c.n_layers)] == \
            [j.is_moe_layer(i) for i in range(j.n_layers)]
        assert [c.is_cross_layer(i) for i in range(c.n_layers)] == \
            [j.is_cross_layer(i) for i in range(j.n_layers)]
        assert (c.cross_attn, c.encoder) == (
            j.cross_attn and type(c.cross_attn)(
                **dataclasses.asdict(j.cross_attn)),
            j.encoder and type(c.encoder)(**dataclasses.asdict(j.encoder)))
    assert get_config(name).dtype == torch.bfloat16
    assert get_config(name).reduced().dtype == torch.float32


# ------------------------------------------------ qwen3-32b, qwen1.5-110b
@pytest.fixture(scope="module", params=DENSE)
def pair(request):
    jm = jax_build(jax_config(request.param).reduced())
    jparams = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    cfg = get_config(request.param).reduced()
    if cfg.qkv_bias:
        rng = np.random.default_rng(7)
        attn = jparams["groups"]["slot0"]["attn"]
        for k in ("bq", "bk", "bv"):
            assert not attn[k].any()          # the reference's zero init
            attn[k] = (0.5 * rng.standard_normal(attn[k].shape)).astype(
                np.float32)
    model = build_model(cfg, params_from_jax(jparams, cfg, device="cpu"),
                        device="cpu")
    return jm, jparams, model


def test_prefill_logits_and_cache_match(pair):
    jm, jparams, model = pair
    toks = np.random.default_rng(0).integers(0, 512, (2, 11)).astype(np.int32)
    jlogits, jcache = jm.prefill(jparams, jnp.asarray(toks))
    logits, k, v = model.prefill(torch.from_numpy(toks))
    _close(logits, jlogits, **LOGIT_TOL)
    _close(k, jcache["slot0"]["k"])
    _close(v, jcache["slot0"]["v"])
    if model.cfg.qkv_bias:
        # the biases move the logits: without them the port disagrees
        bare = build_model(model.cfg, {**model.param_tree(), "layers": [
            {**lp, "attn": {k: (torch.zeros_like(t) if k[0] == "b" else t)
                            for k, t in lp["attn"].items()}}
            for lp in model.param_tree()["layers"]]}, device="cpu")
        assert not np.allclose(bare.prefill(torch.from_numpy(toks))[0],
                               np.asarray(jlogits), **LOGIT_TOL)


def test_chunk_then_decode_logits_match(pair):
    jm, jparams, model = pair
    cfg = model.cfg
    shape = (cfg.n_layers, ROWS, PAGE, cfg.n_kv_heads, cfg.head_dim_)
    rng = np.random.default_rng(1)
    bt = np.array([[3, 5, 7, 0], [2, 4, 0, 0]], np.int32)
    n = np.array([C, 4])
    toks = np.zeros((2, C), np.int32)
    pos = np.zeros((2, C), np.int32)
    rows = np.zeros((2, C), np.int32)
    offs = np.zeros((2, C), np.int32)
    for b in range(2):
        toks[b, :n[b]] = rng.integers(0, cfg.vocab, n[b])
        pos[b, :n[b]] = np.arange(n[b])
        rows[b, :n[b]] = bt[b, pos[b, :n[b]] // PAGE]
        offs[b, :n[b]] = pos[b, :n[b]] % PAGE
    last_idx = (n - 1).astype(np.int32)
    jl, jkp, jvp = jm.prefill_chunk(
        jparams, jnp.zeros(shape), jnp.zeros(shape), *map(jnp.asarray, (
            toks, pos, bt, rows, offs, last_idx)),
        attend=jref.chunk_prefill_attention_ref)
    kp, vp = torch.zeros(shape), torch.zeros(shape)
    t = torch.from_numpy
    logits = model.prefill_chunk(kp, vp, t(toks), t(pos), t(bt), t(rows),
                                 t(offs), t(last_idx),
                                 attend=ops.chunk_prefill_attention)
    _close(logits, jl, **LOGIT_TOL)
    _close(kp, jkp)
    _close(vp, jvp)
    dpos = n.astype(np.int32)
    dtoks = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
    args = (bt, dpos + 1, bt[np.arange(2), dpos // PAGE],
            (dpos % PAGE).astype(np.int32), dtoks, dpos)
    jl, _, jkp2, _ = jm.decode_step_paged(
        jparams, {}, jkp, jvp, *map(jnp.asarray, args),
        attend=jref.paged_attention_ref, inline=True)
    logits = model.decode_step_paged(kp, vp, *map(t, args),
                                     attend=ops.paged_attention, inline=True)
    _close(logits, jl, **LOGIT_TOL)
    _close(kp, jkp2)


@pytest.mark.parametrize("chunk,horizon", [(0, 1), (4, 4)])
def test_greedy_tokens_match_jax_engine(pair, chunk, horizon):
    jm, jparams, model = pair
    rng = np.random.default_rng(2)
    prompts = [[int(t) for t in rng.integers(0, model.cfg.vocab, p)]
               for p in (3, 7, 12, 5, 9)]
    kw = dict(max_slots=3, s_max=64, prefill_chunk_tokens=chunk,
              decode_horizon=horizon)
    jeng = JaxEngine(jm, jparams, JaxAccountant(m_total=512e6),
                     kv_backend="ref", **kw)
    eng = Engine(model, MemoryAccountant(m_total=512e6), device="cpu", **kw)
    for i, p in enumerate(prompts):
        jeng.submit(JaxRequest(req_id=i, tokens=list(p), max_new=10))
        eng.submit(Request(req_id=i, tokens=list(p), max_new=10))
    want = {r.req_id: r.out for r in jeng.drain()}
    assert {r.req_id: r.out for r in eng.drain()} == want
    assert (eng.stat_decode_syncs, eng.stat_prefill_tokens) == (
        jeng.stat_decode_syncs, jeng.stat_prefill_tokens)


# ------------------------------------------------------------ the gateway
ZOO = ("qwen3-8b", "moonshot-v1-16b-a3b", "jamba-v0.1-52b")
REF_HW = cm.HardwareSpec(**dataclasses.asdict(jax_cm.HardwareSpec()))
RTT = np.array([[0.001, 0.04], [0.04, 0.001]])
UNCOMPARED = {"ttft_p50_s", "ttft_p95_s", "engine_prefill_compiles"}
WALL_FIELDS = {"wall_act_s", "ttft_s"}


def _serve(cl, gw_mod, trace_mod, zoo, host, port):
    spec = cl.ClusterSpec(nodes=(cl.NodeSpec(0, max_slots=2),
                                 cl.NodeSpec(1, max_slots=2)),
                          rtt_s=RTT, model_names=ZOO)
    kw = dict(device="cpu") if port else {}
    fleet = cl.build_fleet(spec, zoo=zoo, host=host, **kw)
    if port:
        for node in fleet:          # route by the reference's seconds
            for n, prof in node.profiles.items():
                node.profiles[n] = dataclasses.replace(prof, hw=REF_HW)
            node.residency.hw = REF_HW
    jobs = cl.jobs_from_trace(trace_mod.generate_trace(6, rate=2.0, seed=5),
                              n_clusters=2, prompt_cap=10, gen_cap=8,
                              seed=5)
    gw = gw_mod.ClusterGateway(fleet, RTT, predictor=StubPred(),
                               policy="maestro")
    tokens = {}
    complete = gw._complete

    def record(stage, model, req, now):
        tokens[stage.stage_id] = (model, list(req.out), req.truncated)
        complete(stage, model, req, now)

    gw._complete = record
    m = gw.run(jobs)
    rows = {sid: {k: v for k, v in dataclasses.asdict(e).items()
                  if k not in WALL_FIELDS}
            for sid, e in gw.telemetry.events.items()}
    return tokens, rows, m


def test_gateway_over_a_moe_and_hybrid_zoo_matches_the_reference():
    jzoo, jhost, zoo, host = {}, {}, {}, {}
    for i, name in enumerate(ZOO):
        jzoo[name] = jax_build(jax_config(name).reduced())
        jhost[name] = jax.tree.map(
            np.asarray, jzoo[name].init(jax.random.PRNGKey(1 + i)))
        cfg = get_config(name).reduced()
        host[name] = params_from_jax(jhost[name], cfg, "cpu")
        zoo[name] = build_model(cfg, host[name], device="cpu")
    jtok, jrows, jm = _serve(jax_cluster, jax_gateway, jax_tg, jzoo, jhost,
                             False)
    ptok, prows, pm = _serve(cluster, gateway, tg, zoo, host, True)
    assert ptok == jtok
    assert prows == jrows
    assert {k: v for k, v in pm.row().items() if k not in UNCOMPARED} == \
        {k: v for k, v in jm.row().items() if k not in UNCOMPARED}
    assert pm.finished_jobs == 6 and pm.dropped_jobs == 0
    assert {m for m, _, _ in ptok.values()} == set(ZOO)
