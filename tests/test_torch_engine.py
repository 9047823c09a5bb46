"""The port's serving engine against the JAX engine on the same weights.

Both engines run on the CPU at the reduced (float32) configs: the JAX one
with ``kv_backend="ref"``, the port with ``device="cpu"`` (its plain
paged-attention versions). Greedy tokens must be identical, request by
request, with monolithic and chunked prefill and decode horizons 1 and 8.
The evict-mid-horizon page-leak check and the sync counters are replayed
from ``tests/test_decode_horizon.py``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.runtime.accounting import MemoryAccountant as JaxAccountant
from repro.models import build_model as jax_build
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.runtime.accounting import MemoryAccountant
from repro_torch.core.runtime.kv_pool import VirtualKVPool
from repro_torch.models import build_model
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.kv_arena import KVArena

MODELS = ("qwen3-8b", "starcoder2-15b")


@pytest.fixture(scope="module", params=MODELS)
def pair(request):
    jcfg = jax_config(request.param).reduced()
    jm = jax_build(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    cfg = get_config(request.param).reduced()
    model = build_model(cfg, params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu"), device="cpu")
    return jm, jparams, model


@pytest.fixture(scope="module")
def tiny():
    cfg = get_config("qwen3-8b").reduced()
    return build_model(cfg, device="cpu", seed=0)


def _prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, vocab, p)]
            for p in (3, 7, 12, 5, 9, 14)]


def _drain_jax(jm, jparams, prompts, max_new=12, **kw):
    eng = JaxEngine(jm, jparams, JaxAccountant(m_total=512e6), max_slots=3,
                    s_max=64, kv_backend="ref", **kw)
    for i, p in enumerate(prompts):
        eng.submit(JaxRequest(req_id=i, tokens=list(p), max_new=max_new))
    return eng, {r.req_id: r.out for r in eng.drain()}


def _drain(model, prompts, max_new=12, **kw):
    eng = Engine(model, MemoryAccountant(m_total=512e6), max_slots=3,
                 s_max=64, device="cpu", **kw)
    for i, p in enumerate(prompts):
        eng.submit(Request(req_id=i, tokens=list(p), max_new=max_new))
    return eng, {r.req_id: r.out for r in eng.drain()}


@pytest.mark.parametrize("chunk", [0, 4])
def test_greedy_tokens_match_jax_engine(pair, chunk):
    jm, jparams, model = pair
    prompts = _prompts(model.cfg.vocab)
    for h in (1, 8):
        jeng, want = _drain_jax(jm, jparams, prompts, decode_horizon=h,
                                prefill_chunk_tokens=chunk)
        eng, got = _drain(model, prompts, decode_horizon=h,
                          prefill_chunk_tokens=chunk)
        assert got == want, f"horizon={h} chunk={chunk}"
        assert (eng.stat_decode_syncs, eng.stat_horizon_steps,
                eng.stat_fused_steps, eng.stat_prefill_tokens,
                eng.stat_decode_tokens) == (
            jeng.stat_decode_syncs, jeng.stat_horizon_steps,
            jeng.stat_fused_steps, jeng.stat_prefill_tokens,
            jeng.stat_decode_tokens)
        assert eng.arena.mapped_pages() == 0 and eng.arena.check_mirror()


def test_evict_mid_horizon_frees_pages_and_replays_identically(tiny):
    rng = np.random.default_rng(3)
    prompt = [int(t) for t in rng.integers(0, tiny.cfg.vocab, 24)]
    _, base = _drain(tiny, [prompt], decode_horizon=8)
    acc = MemoryAccountant(m_total=512e6)
    eng = Engine(tiny, acc, max_slots=2, s_max=64, decode_horizon=8,
                 device="cpu")
    eng.submit(Request(req_id=0, tokens=list(prompt), max_new=12))
    eng.step()             # prefill + first token + one horizon launch
    assert eng.stat_horizon_steps == 1
    assert 0 in eng.active and len(eng.active[0].out) > 1
    req = eng.evict(0)
    assert req is not None and req.out == []
    assert eng.arena.mapped_pages() == 0 and eng.arena.mapped_rows() == 0
    assert acc.m_kv == pytest.approx(0.0)
    assert eng.arena.check_mirror()
    eng.submit(req)
    assert {r.req_id: r.out for r in eng.drain()} == base


def test_horizon_sync_counters(tiny):
    """One host sync per horizon launch: 16 decoded tokens take 16 syncs at
    H=1 and ceil(16/8) = 2 at H=8."""
    e1, _ = _drain(tiny, [[1, 2, 3, 4, 5]], max_new=17)
    e8, _ = _drain(tiny, [[1, 2, 3, 4, 5]], max_new=17, decode_horizon=8)
    assert e1.stat_decode_syncs == 16 and e1.stat_horizon_steps == 0
    assert e8.stat_decode_syncs == 2 and e8.stat_horizon_steps == 2
    assert e8.stat_decode_tokens == e1.stat_decode_tokens == 16


def test_engine_defaults_to_cuda_and_refuses_the_unported(tiny):
    acc = MemoryAccountant(m_total=512e6)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Engine(tiny, acc)
    with pytest.raises(NotImplementedError):
        Engine(tiny, acc, prefix_cache=True, device="cpu")


def test_arena_churn_keeps_the_mirror_and_growth_keeps_rows():
    """Random alloc / extend / free churn keeps the pool <-> arena mirror,
    and doubling a plane keeps every written row."""
    acc = MemoryAccountant(m_total=1e9)
    pool = VirtualKVPool(acc, page_bytes=64, page_tokens=4)
    arena = KVArena(page_tokens=4, init_rows=2, device="cpu")
    b = arena.register("m", pool, s_max=64, n_layers=2, n_kv_heads=1,
                       head_dim=2, dtype=torch.float32)
    rng = np.random.default_rng(0)
    live = []
    for sid in range(60):
        op = rng.integers(3)
        if op == 0 or not live:
            if b.alloc_seq(sid, "m", int(rng.integers(1, 20))):
                live.append(sid)
        elif op == 1:
            b.ensure_tokens(live[int(rng.integers(len(live)))],
                            int(rng.integers(1, 60)))
        else:
            b.free_seq(live.pop(int(rng.integers(len(live)))))
        assert arena.check_mirror()
    assert arena.planes[next(iter(arena.planes))].n_rows > 2   # it grew
    sid = 1000
    assert b.alloc_seq(sid, "m", 6)
    k = torch.arange(2 * 6 * 2, dtype=torch.float32).reshape(2, 6, 1, 2)
    b.write_prompt(sid, k, -k)
    plane = b.plane
    before = plane.k[:, b.seq_rows(sid)].clone()
    while plane.free_rows:
        plane.take_row()
    plane.take_row()                                   # forces a doubling
    assert torch.equal(plane.k[:, b.seq_rows(sid)], before)
    assert torch.equal(before.reshape(2, 8, 1, 2)[:, :6], k)
