"""The port's encoder-decoder and cross-attention families against the JAX
package's, on the CPU: reduced whisper-medium (2 decoder layers, each with
a cross-attention sub-layer, over a 2-layer encoder of 24 frames) and
reduced llama-3.2-vision-11b (10 layers, cross-attention on layers 3 and 8
over 24 patch embeddings).

The weights come from the reference's ``init`` through ``params_from_jax``;
the frames and patch embeddings are drawn with numpy and given to both
packages. The encoder's output, the prefill logits, the self-attention K/V
and each cross layer's K/V, and one paged decode step against the cross
cache, are held to the reference at float32: outputs and K/V to 1e-5,
logits to 1e-4 (the zoo's tolerances: a few ulps of values of order one,
grown through the layers). The engines' greedy tokens must be identical,
with the chunk and horizon knobs degrading to 0 and 1 on both sides, the
prefix cache refused and the state cache of equal bytes; and again on the
stub path, with the port engine's stub set to the reference engine's (the
two draw the same distribution, not the same bits). Last, one
virtual-clock gateway run over a reduced zoo of qwen3-8b, whisper-medium
and llama-3.2-vision-11b equals the JAX gateway's per stage and in
``GatewayMetrics`` but ``engine_prefill_compiles`` and the TTFT
percentiles; the port's stubs are patched to the reference's values.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _stubs import StubPred
from repro.configs import get_config as jax_config
from repro.core.predictor import cost_model as jax_cm
from repro.core.runtime.accounting import MemoryAccountant as JaxAccountant
from repro.data import tracegen as jax_tg
from repro.kernels import ref as jref
from repro.models import build_model as jax_build
from repro.serving import cluster as jax_cluster
from repro.serving import gateway as jax_gateway
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.predictor import cost_model as cm
from repro_torch.core.runtime.accounting import MemoryAccountant
from repro_torch.data import tracegen as tg
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.serving import cluster, gateway
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.engine import Engine, Request


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch intra-op thread: test processes that each spin a pool of
    threads on a shared host slow one another down a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MODELS = ("whisper-medium", "llama-3.2-vision-11b")
TOL = dict(rtol=0, atol=1e-5)
LOGIT_TOL = dict(rtol=0, atol=1e-4)
PAGE, ROWS = 4, 12


def _close(got, exp, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(exp),
                               **(tol or TOL))


def _extras(cfg, batch: int, seed: int) -> np.ndarray:
    """Frames or patch embeddings [batch, n_ctx, ctx_width], drawn with
    numpy."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, cfg.n_ctx, cfg.ctx_width)).astype(
        np.float32)


@pytest.fixture(scope="module", params=MODELS)
def pair(request):
    jm = jax_build(jax_config(request.param).reduced())
    jparams = jm.init(jax.random.PRNGKey(0))
    cfg = get_config(request.param).reduced()
    model = build_model(cfg, params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu"), device="cpu")
    return jm, jparams, model


def _ref_layer(jcache, model, i: int, part: str = ""):
    """The reference's cache entry of layer ``i`` (slot ``i % period``,
    group ``i // period``): self K/V, or with ``part="_cross"`` cross."""
    period = model.cfg.layer_pattern_period
    e = jcache[f"slot{i % period}{part}"]
    return np.asarray(e["k"][i // period]), np.asarray(e["v"][i // period])


def test_layers_convert_with_their_cross_parts(pair):
    jm, jparams, model = pair
    cfg = model.cfg
    cross = sorted(model.cross_layer)
    if cfg.family == "encdec":
        assert cross == list(range(cfg.n_layers))
        enc = jparams["encoder"]
        assert len(model.encoder_layers) == cfg.encoder.n_layers == 2
        for i, blk in enumerate(model.encoder_layers):
            assert sorted(blk.ffn) == ["ln", "w_down", "w_up"]   # GELU
            for part in ("attn", "ffn"):
                for k, v in enc["layers"][part].items():
                    np.testing.assert_array_equal(
                        getattr(blk, part)[k].numpy(), np.asarray(v[i]))
        np.testing.assert_array_equal(model.encoder_ln.numpy(),
                                      np.asarray(enc["ln"]))
    else:
        assert cross == [3, 8] and model.encoder_layers is None
    period = cfg.layer_pattern_period
    for i in cross:
        blk = model.layers[i]
        slot = jparams["groups"][f"slot{i % period}"]["cross"]
        assert sorted(blk.cross) == ["ln", "wk", "wo", "wq", "wv"]
        for k, v in slot.items():
            np.testing.assert_array_equal(blk.cross[k].numpy(),
                                          np.asarray(v[i // period]))
    tree = model.param_tree()
    assert build_model(cfg, tree, device="cpu").param_tree().keys() == \
        tree.keys()
    assert not (model.supports_prefix_reuse or model.supports_chunked_prefill
                or model.supports_decode_horizon)
    assert jm.supports_prefix_reuse is False


def test_encode_matches_reference(pair):
    jm, jparams, model = pair
    if model.cfg.encoder is None:
        with pytest.raises(ValueError, match="ctx_embeds"):
            model.prefill(torch.zeros((1, 3), dtype=torch.int32))
        return
    frames = _extras(model.cfg, 2, seed=1)
    want = jm.encode(jparams, jnp.asarray(frames))
    _close(model.encode(torch.from_numpy(frames)), want)


def test_prefill_logits_self_and_cross_kv_match(pair):
    jm, jparams, model = pair
    cfg = model.cfg
    toks = np.random.default_rng(0).integers(0, 512, (2, 11)).astype(np.int32)
    ex = _extras(cfg, 2, seed=2)
    jlogits, jcache = jm.prefill(jparams, jnp.asarray(toks),
                                 {cfg.ctx_key: jnp.asarray(ex)})
    logits, k, v, state = model.prefill_with_state(
        torch.from_numpy(toks), {cfg.ctx_key: torch.from_numpy(ex)})
    _close(logits, jlogits, **LOGIT_TOL)
    for i, a in model.kv_layer.items():
        jk, jv = _ref_layer(jcache, model, i)
        _close(k[a], jk)
        _close(v[a], jv)
    assert sorted(state) == ["cross_k", "cross_v"]
    assert state["cross_k"].shape == (len(model.cross_layer), 2, cfg.n_ctx,
                                      cfg.n_kv_heads, cfg.head_dim_)
    for i, c in model.cross_layer.items():
        jk, jv = _ref_layer(jcache, model, i, "_cross")
        _close(state["cross_k"][c], jk)
        _close(state["cross_v"][c], jv)


def test_paged_decode_reads_the_cross_cache(pair):
    """Prefill two sequences, put the reference's self K/V into pages and
    its cross K/V into both state caches, then one paged decode step each:
    the logits and the new token's K/V agree, and the cross entries stay as
    they were."""
    jm, jparams, model = pair
    cfg = model.cfg
    B, P = 2, 7
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (B, P)).astype(np.int32)
    ex = _extras(cfg, B, seed=4)
    _, jcache = jm.prefill(jparams, jnp.asarray(toks),
                           {cfg.ctx_key: jnp.asarray(ex)})
    bt = np.array([[3, 5, 7, 0], [2, 4, 6, 0]], np.int32)
    shape = (len(model.kv_layer), ROWS, PAGE, cfg.n_kv_heads, cfg.head_dim_)
    kp, vp = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    for i, a in model.kv_layer.items():
        jk, jv = _ref_layer(jcache, model, i)
        for b in range(B):
            for t in range(P):
                kp[a, bt[b, t // PAGE], t % PAGE] = jk[b, t]
                vp[a, bt[b, t // PAGE], t % PAGE] = jv[b, t]
    jstate = {s: jcache[s] for s in jcache if s.endswith("_cross")}
    state = {n: torch.from_numpy(np.stack([
        _ref_layer(jcache, model, i, "_cross")[n == "cross_v"]
        for i in sorted(model.cross_layer)])) for n in ("cross_k", "cross_v")}
    before = {n: t.clone() for n, t in state.items()}
    dpos = np.full(B, P, np.int32)
    dtoks = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
    args = (bt, dpos + 1, bt[np.arange(B), dpos // PAGE],
            (dpos % PAGE).astype(np.int32), dtoks, dpos)
    jl, jstate, jkp, jvp = jm.decode_step_paged(
        jparams, jstate, jnp.asarray(kp), jnp.asarray(vp),
        *map(jnp.asarray, args), attend=jref.paged_attention_ref)
    kp_t, vp_t = torch.from_numpy(kp), torch.from_numpy(vp)
    logits = model.decode_step_paged(
        kp_t, vp_t, *map(torch.from_numpy, args),
        attend=ops.paged_attention, state_cache=state)
    _close(logits, jl, **LOGIT_TOL)
    _close(kp_t, jkp)
    _close(vp_t, jvp)
    for n in state:
        assert torch.equal(state[n], before[n])


def _engines(jm, jparams, model, chunk, horizon):
    kw = dict(max_slots=3, s_max=64, prefill_chunk_tokens=chunk,
              decode_horizon=horizon)
    jacc, acc = JaxAccountant(m_total=512e6), MemoryAccountant(m_total=512e6)
    jeng = JaxEngine(jm, jparams, jacc, kv_backend="ref", prefix_cache=True,
                     **kw)
    eng = Engine(model, acc, device="cpu", prefix_cache=True, **kw)
    assert (eng.chunk_tokens, eng.horizon) == (jeng.chunk_tokens,
                                               jeng.horizon) == (0, 1)
    assert eng.paged and eng._pc is None and jeng._pc is None
    assert eng._state_bytes == jeng._state_bytes > 0
    return jeng, jacc, eng, acc


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, 512, p)]
            for p in (3, 7, 12, 1, 9, 14, 4)]


def _drain_both(jeng, eng, prompts, extras=None):
    for i, p in enumerate(prompts):
        jx = tx = None
        if extras is not None:
            jx = {k: jnp.asarray(a[i:i + 1]) for k, a in extras.items()}
            tx = {k: torch.from_numpy(a[i:i + 1]) for k, a in extras.items()}
        jeng.submit(JaxRequest(req_id=i, tokens=list(p), max_new=10,
                               extras=jx))
        eng.submit(Request(req_id=i, tokens=list(p), max_new=10, extras=tx))
    want = {r.req_id: r.out for r in jeng.drain()}
    got = {r.req_id: r.out for r in eng.drain()}
    return got, want


@pytest.mark.parametrize("chunk,horizon", [(0, 1), (4, 4)])
def test_engine_greedy_tokens_match_jax_engine(pair, chunk, horizon):
    """Each request carries its own frames or patch embeddings."""
    jm, jparams, model = pair
    jeng, jacc, eng, acc = _engines(jm, jparams, model, chunk, horizon)
    prompts = _prompts()
    got, want = _drain_both(jeng, eng, prompts, {
        model.cfg.ctx_key: _extras(model.cfg, len(prompts), seed=5)})
    assert got == want
    counters = ("stat_decode_syncs", "stat_horizon_steps", "stat_fused_steps",
                "stat_prefill_tokens", "stat_decode_tokens", "stat_steps")
    assert ([getattr(eng, c) for c in counters]
            == [getattr(jeng, c) for c in counters])
    assert eng.arena.mapped_pages() == 0 and eng.arena.check_mirror()
    assert acc.ctx == jacc.ctx
    eng.release_kv()
    assert eng.cache is None and acc.ctx == {}


def test_the_stub_path_matches_the_jax_engine(pair):
    """Requests without extras prefill against the engine's stub. The
    port's stub is the reference's distribution, drawn once per engine;
    with it set to the reference engine's values the tokens agree."""
    jm, jparams, model = pair
    cfg = model.cfg
    jeng, _, eng, _ = _engines(jm, jparams, model, 0, 1)
    stub = eng._modal_extras[cfg.ctx_key]
    assert stub.shape == (1, cfg.n_ctx, cfg.ctx_width)
    assert stub.dtype == cfg.dtype and stub.device.type == "cpu"
    again = Engine(model, MemoryAccountant(m_total=512e6), device="cpu")
    assert torch.equal(again._modal_extras[cfg.ctx_key], stub)
    assert abs(float(stub.mean())) < 0.1 and abs(float(stub.std()) - 1) < 0.1
    jstub = np.asarray(jeng._modal_extras[cfg.ctx_key])
    assert jstub.shape == tuple(stub.shape)
    eng._modal_extras = {cfg.ctx_key: torch.from_numpy(jstub.copy())}
    got, want = _drain_both(jeng, eng, _prompts(seed=1))
    assert got == want


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", MODELS + ("qwen3-8b",))
def test_context_key_and_width_match_the_reference_stub(name, reduced):
    """``ctx_key`` and ``ctx_width`` name the reference engine's stub:
    its one key, and its shape [1, n_ctx, ctx_width]; none for a text
    model."""
    cfg, jcfg = get_config(name), jax_config(name)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    ref = JaxEngine._make_modal_extras(types.SimpleNamespace(
        model=types.SimpleNamespace(cfg=jcfg)))
    if ref is None:
        assert (cfg.ctx_key, cfg.ctx_width, cfg.n_ctx) == ("", 0, 0)
        return
    assert {k: a.shape for k, a in ref.items()} == {
        cfg.ctx_key: (1, cfg.n_ctx, cfg.ctx_width)}


# ------------------------------------------------------------ the gateway
ZOO = ("qwen3-8b", "whisper-medium", "llama-3.2-vision-11b")
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
    jobs = cl.jobs_from_trace(trace_mod.generate_trace(8, rate=2.0, seed=5),
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


def test_gateway_over_a_cross_attention_zoo_matches_the_reference(
        monkeypatch):
    jzoo, jhost, zoo, host, stubs = {}, {}, {}, {}, {}
    for i, name in enumerate(ZOO):
        jzoo[name] = jax_build(jax_config(name).reduced())
        jhost[name] = jax.tree.map(
            np.asarray, jzoo[name].init(jax.random.PRNGKey(1 + i)))
        cfg = get_config(name).reduced()
        host[name] = params_from_jax(jhost[name], cfg, "cpu")
        zoo[name] = build_model(cfg, host[name], device="cpu")
        # the reference engine's own stub for this model
        ref = JaxEngine._make_modal_extras(
            types.SimpleNamespace(model=jzoo[name]))
        stubs[cfg.name] = (None if ref is None else
                           {k: np.asarray(a) for k, a in ref.items()})
    assert stubs["qwen3-8b-smoke"] is None

    def ref_stub(self):
        s = stubs[self.model.cfg.name]
        return None if s is None else {
            k: torch.from_numpy(a.copy()) for k, a in s.items()}

    monkeypatch.setattr(engine_mod.Engine, "_make_modal_extras", ref_stub)
    jtok, jrows, jm = _serve(jax_cluster, jax_gateway, jax_tg, jzoo, jhost,
                             False)
    ptok, prows, pm = _serve(cluster, gateway, tg, zoo, host, True)
    assert ptok == jtok
    assert prows == jrows
    assert {k: v for k, v in pm.row().items() if k not in UNCOMPARED} == \
        {k: v for k, v in jm.row().items() if k not in UNCOMPARED}
    assert pm.finished_jobs == 8 and pm.dropped_jobs == 0
    assert {m for m, _, _ in ptok.values()} == set(ZOO)
