"""The port's MoE FFN and MoE models against the JAX package's, on the CPU.

The routing core (``_route_and_bucket``, ``_combine``, ``moe_apply``) takes
the same seeded numpy inputs as the reference's local path: buckets, ranks,
keep masks and outputs to 1e-5 at float32, the picked experts and the drops
exactly. Ties pick the lower expert index, a router that sends every token
to one expert drops the pairs past its capacity (the later tokens), and a
one-token step (``S == 1``) drops nothing. The reduced moonshot-v1-16b-a3b
(64 -> 4 experts, top-6 -> top-2) and llama4-scout-17b-a16e (top-1) take
the JAX model's weights through ``params_from_jax``: prefill, one chunk
and one paged decode step give the reference's float32 logits to 1e-4 and
its planes to 1e-5, and the engines' greedy tokens are identical, chunked
(pad rows routed and taking capacity), monolithic, at horizon 4, and with
the prefix cache on.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.runtime.accounting import MemoryAccountant as JaxAccountant
from repro.distributed.sharding import ShardingCtx
from repro.kernels import ref as jref
from repro.models import build_model as jax_build
from repro.models import moe as jmoe
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.runtime.accounting import MemoryAccountant
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.models import moe
from repro_torch.serving.engine import Engine, Request, pad_writes


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch intra-op thread: test processes that each spin a pool of
    threads on a shared host slow one another down a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MODELS = ("moonshot-v1-16b-a3b", "llama4-scout-17b-a16e")
TOL = dict(rtol=0, atol=1e-5)
LOGIT_TOL = dict(rtol=0, atol=1e-4)
PAGE, ROWS, C = 4, 12, 6


def _close(got, exp, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(exp),
                               **(tol or TOL))


# ----------------------------------------------------------- routing core
def _moe_params(rng, D, E, F):
    def s(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(
            np.float32)

    return {"ln": np.ones(D, np.float32), "router": s(D, E),
            "w_gate": s(E, D, F), "w_up": s(E, D, F), "w_down": s(E, F, D)}


def _both_routes(xt, router, E, K, Cap):
    jbuf, (je, jr, jk, jg) = jmoe._route_and_bucket(
        jnp.asarray(xt), jnp.asarray(router), E, K, Cap)
    buf, (e, r, k, g) = moe._route_and_bucket(
        torch.from_numpy(xt), torch.from_numpy(router), E, K, Cap)
    assert np.array_equal(e.numpy(), np.asarray(je))
    assert np.array_equal(r.numpy(), np.asarray(jr))
    assert np.array_equal(k.numpy(), np.asarray(jk))
    _close(buf, jbuf)
    _close(g, jg)
    return (jbuf, (je, jr, jk, jg)), (buf, (e, r, k, g))


@pytest.mark.parametrize("T,D,E,K", [(16, 32, 4, 2), (40, 64, 64, 6),
                                     (24, 32, 16, 1), (7, 16, 8, 3)])
def test_route_bucket_and_combine_match_the_reference(T, D, E, K):
    rng = np.random.default_rng(T * E + K)
    xt = rng.standard_normal((T, D), np.float32)
    router = rng.standard_normal((D, E), np.float32)
    Cap = jmoe._capacity(T, E, K, 1.25)
    assert moe._capacity(T, E, K, 1.25) == Cap
    (jbuf, jinfo), (buf, info) = _both_routes(xt, router, E, K, Cap)
    out = rng.standard_normal(buf.shape, np.float32)
    _close(moe._combine(torch.from_numpy(out), info, T, K, Cap),
           jmoe._combine(jnp.asarray(out), jinfo, T, K, Cap))


@pytest.mark.parametrize("B,S", [(2, 9), (3, 1), (1, 1)])
def test_moe_apply_matches_the_reference(B, S):
    cfg = get_config("moonshot-v1-16b-a3b").reduced()
    jcfg = jax_config("moonshot-v1-16b-a3b").reduced()
    m = cfg.moe
    rng = np.random.default_rng(B * 10 + S)
    p = _moe_params(rng, cfg.d_model, m.n_experts, m.d_ff_expert)
    x = rng.standard_normal((B, S, cfg.d_model), np.float32)
    want = jmoe.moe_apply({k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x), jcfg, ShardingCtx(None))
    got = moe.moe_apply({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x), cfg)
    _close(got, want)


def test_a_router_sending_every_token_to_one_expert_drops_the_later_pairs():
    """Every token's first choice is expert 2: of T pairs on it, the first
    C (in token order) are kept and the rest dropped, as the reference
    drops them; a dropped pair adds nothing to its token's output."""
    T, D, E, K = 16, 32, 4, 2
    rng = np.random.default_rng(3)
    xt = np.abs(rng.standard_normal((T, D), np.float32)) + 0.1
    router = rng.standard_normal((D, E), np.float32) * 0.01
    router[:, 2] = 1.0
    Cap = jmoe._capacity(T, E, K, 1.25)
    assert Cap == 10
    _, (buf, (e, rank, keep, g)) = _both_routes(xt, router, E, K, Cap)
    first = e.reshape(T, K)[:, 0]
    assert (first == 2).all()
    kept = keep.reshape(T, K)[:, 0]
    assert kept.tolist() == [True] * Cap + [False] * (T - Cap)
    out = torch.randn(buf.shape)
    y = moe._combine(out, (e, rank, keep, g), T, K, Cap)
    # a token whose expert-2 pair dropped gets only its second pick
    t = T - 1
    e2, r2 = int(e[t * K + 1]), int(rank[t * K + 1])
    want = out[e2, r2] * g[t, 1] if keep[t * K + 1] else torch.zeros(D)
    torch.testing.assert_close(y[t], want)


def test_tied_router_columns_pick_the_lower_expert_index():
    """Equal router columns give equal probabilities: the top-k are the
    lowest indices among the tied, as ``lax.top_k`` picks them."""
    T, D, E, K = 8, 16, 8, 3
    rng = np.random.default_rng(4)
    xt = rng.standard_normal((T, D), np.float32)
    col = rng.standard_normal((D, 1), np.float32)
    router = np.repeat(col, E, axis=1)                  # every column tied
    router[:, 5] += 2.0 * np.sign(xt.mean(0))           # one expert ahead
    Cap = jmoe._capacity(T, E, K, 1.25)
    _, (_, (e, _, _, _)) = _both_routes(xt, router, E, K, Cap)
    picks = e.reshape(T, K)
    lead = (xt @ router).argmax(1)
    for t in range(T):
        rest = [i for i in range(E) if i != lead[t]][:K - 1]
        assert picks[t].tolist() == [int(lead[t])] + rest


def test_a_one_token_step_is_dropless():
    """``S == 1`` sizes every expert for all pairs: with every token on one
    expert nothing drops, and the output is the unbucketed sum of each
    token's gated expert outputs."""
    cfg = get_config("moonshot-v1-16b-a3b").reduced()
    m = cfg.moe
    B, D = 6, cfg.d_model
    rng = np.random.default_rng(5)
    p = {k: torch.from_numpy(v) for k, v in
         _moe_params(rng, D, m.n_experts, m.d_ff_expert).items()}
    p["router"][:, 1] += 3.0
    x = torch.from_numpy(np.abs(rng.standard_normal((B, 1, D), np.float32)))
    assert moe._capacity(B, m.n_experts, m.top_k, m.capacity_factor,
                         dropless=True) == B * m.top_k
    got = moe.moe_apply(p, x, cfg)[:, 0]
    h = moe.rms_norm(x[:, 0], p["ln"], cfg.norm_eps)
    probs = torch.softmax(h @ p["router"], dim=-1)
    gv, gi = probs.topk(m.top_k, dim=-1)
    assert (gi[:, 0] == 1).all()
    want = torch.zeros(B, D)
    for t in range(B):
        for k in range(m.top_k):
            e = int(gi[t, k])
            a = torch.nn.functional.silu(h[t] @ p["w_gate"][e])
            want[t] += gv[t, k] * ((a * (h[t] @ p["w_up"][e]))
                                   @ p["w_down"][e])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ the models
@pytest.fixture(scope="module", params=MODELS)
def pair(request):
    jcfg = jax_config(request.param).reduced()
    jm = jax_build(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    cfg = get_config(request.param).reduced()
    model = build_model(cfg, params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu"), device="cpu")
    return jm, jparams, model


def test_the_layers_hold_a_moe_ffn(pair):
    _, jparams, model = pair
    assert model.cfg.family == "moe"
    assert all(b.ffn is None and b.moe is not None for b in model.layers)
    assert model.supports_chunked_prefill and model.supports_decode_horizon
    assert model.supports_prefix_reuse
    for k, v in jparams["groups"]["slot0"]["moe"].items():
        for i, blk in enumerate(model.layers):
            _close(blk.moe[k], v[i], rtol=0, atol=0)


def test_prefill_logits_and_cache_match(pair):
    jm, jparams, model = pair
    toks = np.random.default_rng(0).integers(0, 512, (2, 11)).astype(np.int32)
    jlogits, jcache = jm.prefill(jparams, jnp.asarray(toks))
    logits, k, v = model.prefill(torch.from_numpy(toks))
    _close(logits, jlogits, **LOGIT_TOL)
    _close(k, jcache["slot0"]["k"])
    _close(v, jcache["slot0"]["v"])


def test_chunk_then_decode_logits_match(pair):
    """One prefill chunk of two sequences, one of them half pad (its pad
    rows routed with the rest), then one decode step with the splice off
    and on."""
    jm, jparams, model = pair
    cfg = model.cfg
    L, Hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim_
    B = 2
    rng = np.random.default_rng(1)
    bt = np.array([[3, 5, 7, 0], [2, 4, 0, 0]], np.int32)
    n = np.array([C, 3])
    toks = np.zeros((B, C), np.int32)
    pos = np.zeros((B, C), np.int32)
    rows = np.zeros((B, C), np.int32)
    offs = np.zeros((B, C), np.int32)
    for b in range(B):
        toks[b, :n[b]] = rng.integers(0, cfg.vocab, n[b])
        pos[b, :n[b]] = np.arange(n[b])
        rows[b, :n[b]] = bt[b, pos[b, :n[b]] // PAGE]
        offs[b, :n[b]] = pos[b, :n[b]] % PAGE
    last_idx = (n - 1).astype(np.int32)
    shape = (L, ROWS, PAGE, Hkv, hd)
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
    dtoks = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
    drows = bt[np.arange(B), dpos // PAGE]
    doffs = (dpos % PAGE).astype(np.int32)
    seq_lens = (dpos + 1).astype(np.int32)
    for inline in (False, True):
        jl, _, jkp2, _ = jm.decode_step_paged(
            jparams, {}, jkp, jvp, *map(jnp.asarray, (
                bt, seq_lens, drows, doffs, dtoks, dpos)),
            attend=jref.paged_attention_ref, inline=inline)
        kp2, vp2 = kp.clone(), vp.clone()
        logits = model.decode_step_paged(
            kp2, vp2, t(bt), t(seq_lens), t(drows), t(doffs), t(dtoks),
            t(dpos), attend=ops.paged_attention, inline=inline)
        _close(logits, jl, **LOGIT_TOL)
        _close(kp2, jkp2)


def _prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, vocab, p)]
            for p in (3, 7, 12, 5, 9, 14, 1)]


def _drain_jax(jm, jparams, prompts, max_new=10, **kw):
    eng = JaxEngine(jm, jparams, JaxAccountant(m_total=512e6), max_slots=3,
                    s_max=64, kv_backend="ref", **kw)
    for i, p in enumerate(prompts):
        eng.submit(JaxRequest(req_id=i, tokens=list(p), max_new=max_new))
    return eng, {r.req_id: r.out for r in eng.drain()}


def _drain(model, prompts, max_new=10, **kw):
    eng = Engine(model, MemoryAccountant(m_total=512e6), max_slots=3,
                 s_max=64, device="cpu", **kw)
    for i, p in enumerate(prompts):
        eng.submit(Request(req_id=i, tokens=list(p), max_new=max_new))
    return eng, {r.req_id: r.out for r in eng.drain()}


@pytest.mark.parametrize("chunk,horizon", [(0, 1), (8, 1), (0, 4), (8, 4)])
def test_greedy_tokens_match_jax_engine(pair, chunk, horizon, monkeypatch):
    """Seven prompts (one of a single token, dropless) on three slots:
    chunked steps route the idle and decoding slots' pad rows beside the
    real ones. Prefill drops pairs past capacity (the chunks' identical
    pad rows crowd their experts); decode drops none."""
    jm, jparams, model = pair
    prompts = _prompts(model.cfg.vocab)
    kw = dict(decode_horizon=horizon, prefill_chunk_tokens=chunk)
    jeng, want = _drain_jax(jm, jparams, prompts, **kw)
    dropped = []
    route = moe._route_and_bucket

    def counting(xt, router, E, K, C):
        buf, info = route(xt, router, E, K, C)
        dropped.append(int((~info[2]).sum()))
        return buf, info

    monkeypatch.setattr(moe, "_route_and_bucket", counting)
    eng, got = _drain(model, prompts, **kw)
    assert got == want
    assert sum(dropped) > 0
    assert (eng.chunk_tokens, eng.horizon) == (chunk, horizon)
    assert (eng.stat_decode_syncs, eng.stat_horizon_steps,
            eng.stat_fused_steps, eng.stat_prefill_tokens,
            eng.stat_decode_tokens) == (
        jeng.stat_decode_syncs, jeng.stat_horizon_steps,
        jeng.stat_fused_steps, jeng.stat_prefill_tokens,
        jeng.stat_decode_tokens)
    assert eng.arena.mapped_pages() == 0 and eng.arena.check_mirror()


@pytest.mark.parametrize("chunk", [0, 8])
def test_prefix_cache_tokens_match_jax_engine(pair, chunk):
    """A shared 32-token prefix: the later prompts' suffixes run as [1, S]
    (monolithic) or from their first unmatched chunk, routed as the
    reference routes them."""
    jm, jparams, model = pair
    rng = np.random.default_rng(6)
    base = [int(t) for t in rng.integers(0, model.cfg.vocab, 40)]
    prompts = [base, base[:32] + [3, 1, 4, 1, 5], base[:20] + [7] * 11,
               base[:32] + [3, 1, 4, 1, 5]]
    kw = dict(max_slots=2, s_max=64, prefill_chunk_tokens=chunk,
              decode_horizon=4, prefix_cache=True)
    want, got = {}, {}
    jeng = JaxEngine(jm, jparams, JaxAccountant(m_total=512e6),
                     kv_backend="ref", **kw)
    eng = Engine(model, MemoryAccountant(m_total=512e6), device="cpu", **kw)
    for i, p in enumerate(prompts):
        jeng.submit(JaxRequest(req_id=i, tokens=list(p), max_new=8))
        eng.submit(Request(req_id=i, tokens=list(p), max_new=8))
        want.update({r.req_id: (r.out, r.prefill_avoided)
                     for r in jeng.drain()})
        got.update({r.req_id: (r.out, r.prefill_avoided)
                    for r in eng.drain()})
    assert got == want
    assert [got[i][1] for i in range(4)] == [0, 32, 20, 32]
    assert eng._pc.stats() == jeng._pc.stats()


def test_duplicate_page_writes_keep_the_last_one():
    """A chunk's pad columns all write the null row, whose offset 0 the
    idle lanes' pad rows read: after ``pad_writes`` only the last pad
    column (row-major) writes there, as a sequential scatter (the
    reference's on the CPU) leaves it, so a scatter that lands duplicates
    in any order (the card's) leaves every read slot the same."""
    page, C = 4, 4
    rows = np.array([[3, 3, 0, 0], [0, 0, 0, 0], [5, 0, 0, 0]], np.int32)
    offs = np.array([[0, 1, 0, 0], [0, 0, 0, 0], [2, 0, 0, 0]], np.int32)
    last_idx = np.array([1, 0, 0], np.int32)
    vals = np.arange(rows.size, dtype=np.float32)

    def scatter(r, o, order):
        plane = np.full((6, page), -1.0, np.float32)
        for i in order:
            plane[r.flat[i], o.flat[i]] = vals[i]
        return plane

    seq = scatter(rows, offs, range(rows.size))
    spread = offs.copy()
    pad_writes(spread, last_idx, [0, 2], page)
    assert (spread == np.array([[0, 1, 3, 3], [3, 3, 3, 3],
                                [2, 3, 3, 0]])).all()
    rng = np.random.default_rng(0)
    read = [(3, 0), (3, 1), (5, 2), (0, 0)]     # real slots, null offset 0
    for _ in range(8):
        got = scatter(rows, spread, rng.permutation(rows.size))
        assert [got[r] for r in read] == [seq[r] for r in read]
    assert seq[0, 0] == vals[-1]
