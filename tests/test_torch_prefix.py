"""The port's prefix-cache path against the JAX package's, on the CPU.

Digests are compared as strings; the arena's aliasing, copy-on-write and
index eviction replay ``tests/test_prefix_cache.py`` on the port's arena;
``Model.prefill_suffix`` (one paged chunk of the sequence) is held against
the JAX ``prefill_suffix`` (gather, concat, einsum) at float32: logits to
1e-4, the suffix's K/V in the plane to 1e-5; and the two engines, prefix
cache on, must give identical greedy tokens and identical hit counters on
the four prompts of ``tests/test_decode_horizon.py`` (full-page hits, a
one-page hit and a partial-page hit whose suffix ends inside the copied
page), monolithic and chunked, horizons 1 and 8. A later repeat of a hit
must give the same tokens again, and every row the index pins must hold
the K/V of its prefix: a write onto a shared row would break both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.runtime.accounting import MemoryAccountant as JaxAccountant
from repro.models import build_model as jax_build
from repro.serving import prefix_cache as jax_pc
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.runtime.accounting import MemoryAccountant
from repro_torch.core.runtime.kv_pool import VirtualKVPool
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.kv_arena import KVArena
from repro_torch.serving.prefix_cache import (PrefixCacheConfig,
                                              page_digests, root_key)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch intra-op thread: test processes that each spin a pool of
    threads on a shared host slow one another down a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MODELS = ("qwen3-8b", "starcoder2-15b")
GEO = dict(n_layers=2, n_kv_heads=2, head_dim=32, dtype=torch.float32)
ALPHA = 2 * 2 * 2 * 32 * 4


@pytest.fixture(scope="module", params=MODELS)
def pair(request):
    jcfg = jax_config(request.param).reduced()
    jm = jax_build(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    cfg = get_config(request.param).reduced()
    model = build_model(cfg, params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu"), device="cpu")
    return jm, jparams, model


def _bind(arena, acc, name="m"):
    pool = VirtualKVPool(acc, page_bytes=ALPHA * arena.page_tokens,
                         page_tokens=arena.page_tokens)
    return arena.register(name, pool, s_max=256, **GEO)


# --------------------------------------------------------------- digests
@pytest.mark.parametrize("n,page,ns", [(40, 16, "qwen3-8b"), (7, 4, "m"),
                                       (64, 16, "starcoder2-15b"),
                                       (3, 16, "m")])
def test_page_digests_equal_the_reference(n, page, ns):
    """The same strings as the JAX package: a gateway routes by them."""
    rng = np.random.default_rng(n)
    toks = [int(t) for t in rng.integers(0, 151936, n)]
    got = page_digests(toks, page, ns)
    assert got == jax_pc.page_digests(toks, page, ns)
    # numpy integers hash like Python ints, as in the reference
    assert got == page_digests(list(np.asarray(toks, np.int64)), page, ns)
    assert len(got) == n // page
    assert root_key(ns) == jax_pc.root_key(ns)


# ----------------------------------------------------- arena-level sharing
def test_alias_refcounts_cow_and_flush():
    acc = MemoryAccountant(m_total=4e6)
    arena = KVArena(page_tokens=16, device="cpu")
    b = _bind(arena, acc)
    idx = arena.enable_prefix_cache(acc, PrefixCacheConfig(max_pages=8))
    assert b.alloc_seq(0, "m", tokens=40)                  # 3 pages
    rows = b.seq_rows(0)
    b.plane.k[:, rows[0]] = 1.5
    b.plane.v[:, rows[0]] = -2.5
    toks = list(range(48))
    digs = page_digests(toks, 16, "m")
    parent = root_key("m")
    for i, d in enumerate(digs[:2]):
        assert idx.insert("m", d, parent, b.plane, rows[i],
                          toks[16 * i:16 * (i + 1)], 16 * (i + 1))
        parent = d
    assert arena.check_mirror()
    assert b.plane.refs[rows[0]] == 2                      # mapping + pin
    # pinned prefixes survive the sequence's release
    b.free_seq(0)
    assert arena.mapped_pages() == 0
    assert b.plane.refs[rows[0]] == 1 and b.plane.refs[rows[1]] == 1
    assert arena.check_mirror()
    assert acc.m_kv == pytest.approx(0.0)
    assert idx.pinned_bytes() == 2 * b.plane.spec.row_bytes
    assert acc.ctx["prefix-cache"] == idx.pinned_bytes()
    # a new sequence aliases the cached rows instead of allocating
    assert b.alloc_seq(1, "m", tokens=40, alias_rows=rows[:2])
    assert b.seq_rows(1)[:2] == rows[:2]
    assert b.plane.refs[rows[0]] == 2
    assert arena.pages_aliased == 2
    assert arena.check_mirror()
    # COW privatises a shared page, copying every layer of it; the original
    # row keeps its pin and its contents
    assert b.make_private(1, 0)
    new = b.seq_rows(1)[0]
    assert new != rows[0]
    assert torch.equal(b.plane.k[:, new], b.plane.k[:, rows[0]])
    assert bool((b.plane.k[:, new] == 1.5).all())
    assert bool((b.plane.v[:, new] == -2.5).all())
    assert b.plane.refs[rows[0]] == 1
    assert arena.cow_copies == 1
    assert not b.make_private(1, 0)                        # already private
    assert arena.check_mirror()
    b.free_seq(1)
    # flush releases every pin and the accountant context
    idx.flush()
    assert not idx.entries and idx.pinned_bytes() == 0
    assert arena.mapped_rows() == 0
    assert all(not p.refs for p in arena.planes.values())
    assert arena.check_mirror()
    assert acc.check_invariant()
    assert "prefix-cache" not in acc.ctx
    stats = arena.stats()
    assert (stats["pages_aliased"], stats["cow_copies"]) == (2, 1)
    assert stats["peak_mapped_pages"] == 3 and arena.peak_rows == 3


def test_index_eviction_under_cap():
    acc = MemoryAccountant(m_total=4e6)
    arena = KVArena(page_tokens=16, device="cpu")
    b = _bind(arena, acc)
    idx = arena.enable_prefix_cache(acc, PrefixCacheConfig(max_pages=2))
    assert b.alloc_seq(0, "m", tokens=80)                  # 5 pages
    rows = b.seq_rows(0)
    toks = list(range(80))
    digs = page_digests(toks, 16, "m")
    parent = root_key("m")
    for i, d in enumerate(digs):
        idx.insert("m", d, parent, b.plane, rows[i],
                   toks[16 * i:16 * (i + 1)], 16 * (i + 1))
        parent = d
    assert len(idx.entries) == 2 and idx.evictions == 3    # LRU capped
    assert arena.check_mirror()
    b.free_seq(0)
    idx.flush()
    assert arena.check_mirror() and acc.m_kv == pytest.approx(0.0)


def test_copy_row_on_a_full_plane_grows_it_and_copies_the_source():
    """``copy_row`` takes its destination first: on a full plane that
    doubles the plane (new tensors), and the source is read from them."""
    acc = MemoryAccountant(m_total=4e6)
    arena = KVArena(page_tokens=4, init_rows=4, device="cpu")
    b = _bind(arena, acc)
    assert b.alloc_seq(0, "m", tokens=12)                  # rows 1..3: full
    plane = b.plane
    src = b.seq_rows(0)[1]
    plane.k[:, src] = torch.arange(2 * 4 * 2 * 32, dtype=torch.float32
                                   ).reshape(2, 4, 2, 32)
    plane.share_row(src)                                   # a pin
    assert not plane.free_rows
    assert b.make_private(0, 1)
    assert plane.n_rows == 8
    dst = b.seq_rows(0)[1]
    assert torch.equal(plane.k[:, dst], plane.k[:, src])
    assert float(plane.k[:, dst].sum()) > 0
    plane.drop_row(src)
    assert arena.check_mirror()


# ------------------------------------------------------ model: the suffix
@pytest.mark.parametrize("M,S", [(16, 9), (20, 11), (37, 1)])
def test_prefill_suffix_matches_jax(pair, M, S):
    """The suffix after M cached tokens: the port's paged chunk against the
    JAX gather-concat-einsum, from the same prefix K/V."""
    jm, jparams, model = pair
    rng = np.random.default_rng(M)
    toks = rng.integers(0, model.cfg.vocab, M + S).astype(np.int32)
    _, jcache = jm.prefill(jparams, jnp.asarray(toks[None, :M]))
    pk = jnp.concatenate([jcache["slot0"]["k"][:, 0]], axis=0)
    pv = jnp.concatenate([jcache["slot0"]["v"][:, 0]], axis=0)
    want, k_sfx, v_sfx = jm.prefill_suffix(jparams,
                                           jnp.asarray(toks[None, M:]),
                                           pk, pv)
    page = 8
    L, Hkv, hd = model.cfg.n_layers, model.cfg.n_kv_heads, \
        model.cfg.head_dim_
    n_pages = -(-(M + S) // page)
    rows = np.random.default_rng(1).permutation(np.arange(1, 3 * n_pages))[
        :n_pages]
    kp = torch.zeros((L, 3 * n_pages, page, Hkv, hd))
    vp = torch.zeros_like(kp)
    pad = n_pages * page - M
    for plane, src in ((kp, pk), (vp, pv)):
        t = torch.from_numpy(np.pad(np.asarray(src),
                                    ((0, 0), (0, pad), (0, 0), (0, 0))))
        # the rest of the prefix's last page holds another prompt's K/V,
        # as a copied partial page does
        t[:, M:] = 7.0
        plane[:, torch.from_numpy(rows).long()] = t.reshape(
            L, n_pages, page, Hkv, hd)
    bt = torch.zeros((1, n_pages + 2), dtype=torch.int32)
    bt[0, :n_pages] = torch.from_numpy(rows.astype(np.int32))
    got = model.prefill_suffix(kp, vp, torch.from_numpy(toks[None, M:]), M,
                               bt, attend=ops.chunk_prefill_attention)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    flat_k = kp[:, torch.from_numpy(rows).long()].reshape(L, -1, Hkv, hd)
    flat_v = vp[:, torch.from_numpy(rows).long()].reshape(L, -1, Hkv, hd)
    np.testing.assert_allclose(flat_k[:, M:M + S].numpy(),
                               np.asarray(k_sfx[:, 0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(flat_v[:, M:M + S].numpy(),
                               np.asarray(v_sfx[:, 0]), rtol=1e-5, atol=1e-5)
    # the prefix is untouched
    np.testing.assert_array_equal(flat_k[:, :M].numpy(), np.asarray(pk))


# ----------------------------------------------------------- engine level
def _workflow(vocab):
    rng = np.random.default_rng(5)
    base = [int(t) for t in rng.integers(0, vocab, 40)]
    return [base,                          # indexes 2 full pages
            base[:32] + [3, 1, 4, 1, 5],   # hits both full pages
            base[:16] + [9] * 20,          # hits page 0 only
            base[:20] + [7] * 11]          # partial-page COW hit


def _run_seq(make, req_cls, prompts, max_new=8):
    """One prompt at a time (drained between), so later prompts can hit
    the prefixes of earlier ones."""
    eng = make()
    out = {}
    for i, p in enumerate(prompts):
        eng.submit(req_cls(req_id=i, tokens=list(p), max_new=max_new))
        for r in eng.drain():
            out[r.req_id] = r
    return eng, out


def _prefix_tokens(idx, entry):
    """The whole prefix an index entry covers, from its parent chain."""
    parts = [entry.tokens]
    while entry.parent in idx.entries:
        entry = idx.entries[entry.parent]
        parts.append(entry.tokens)
    return [t for part in reversed(parts) for t in part]


@pytest.mark.parametrize("horizon", [1, 8])
@pytest.mark.parametrize("chunk", [0, 8])
def test_engine_prefix_cache_matches_jax_engine(pair, chunk, horizon):
    jm, jparams, model = pair
    prompts = _workflow(model.cfg.vocab)
    prompts = prompts + [prompts[1]]       # a later hit on the same prefix
    kw = dict(max_slots=2, s_max=64, decode_horizon=horizon,
              prefill_chunk_tokens=chunk)
    jeng, want = _run_seq(lambda: JaxEngine(
        jm, jparams, JaxAccountant(m_total=512e6), kv_backend="ref",
        prefix_cache=True, **kw), JaxRequest, prompts)
    eng, got = _run_seq(lambda: Engine(
        model, MemoryAccountant(m_total=512e6), device="cpu",
        prefix_cache=True, **kw), Request, prompts)
    _, off = _run_seq(lambda: Engine(
        model, MemoryAccountant(m_total=512e6), device="cpu", **kw),
        Request, prompts)
    outs = {k: r.out for k, r in got.items()}
    assert outs == {k: r.out for k, r in want.items()}
    assert outs == {k: r.out for k, r in off.items()}
    assert outs[4] == outs[1]
    avoided = [got[k].prefill_avoided for k in sorted(got)]
    assert avoided == [0, 32, 16, 20, 32]
    assert avoided == [want[k].prefill_avoided for k in sorted(want)]
    assert (eng.arena.cow_copies, eng.arena.pages_aliased) == \
        (jeng.arena.cow_copies, jeng.arena.pages_aliased)
    assert eng._pc.stats() == jeng._pc.stats()
    assert (eng.stat_prefill_tokens, eng.stat_decode_tokens,
            eng.stat_decode_syncs) == (
        jeng.stat_prefill_tokens, jeng.stat_decode_tokens,
        jeng.stat_decode_syncs)
    assert eng.arena.check_mirror() and eng.arena.mapped_pages() == 0
    assert eng.acc.ctx["prefix-cache"] == jeng.acc.ctx["prefix-cache"]
    # every pinned row still holds the K/V of the prefix it indexes
    plane, page = eng.binding.plane, eng.page_tokens
    for e in eng._pc.entries.values():
        toks = _prefix_tokens(eng._pc, e)
        assert len(toks) == e.n_prefix_tokens
        _, k, v = model.prefill(torch.tensor([toks]))
        torch.testing.assert_close(plane.k[:, e.row], k[:, 0, -page:],
                                   rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(plane.v[:, e.row], v[:, 0, -page:],
                                   rtol=1e-5, atol=1e-5)


def test_engine_sleep_recovers_all_headroom(pair):
    _, _, model = pair
    base = _workflow(model.cfg.vocab)[0]
    eng, _ = _run_seq(lambda: Engine(
        model, MemoryAccountant(m_total=256e6), max_slots=2, s_max=64,
        device="cpu", prefix_cache=True), Request,
        [base, base[:32] + [1, 2, 3]])
    acc = eng.acc
    assert eng._pc.entries and acc.ctx.get("prefix-cache", 0) > 0
    eng.release_kv()
    assert not eng._pc.entries
    assert "prefix-cache" not in acc.ctx
    assert eng.arena.mapped_pages() == 0 and eng.arena.mapped_rows() == 0
    assert all(not p.refs for p in eng.arena.planes.values())
    assert acc.m_kv == pytest.approx(0.0)
    assert eng.arena.check_mirror() and acc.check_invariant()


def test_disabled_cache_changes_nothing(pair):
    _, _, model = pair
    prompt = _workflow(model.cfg.vocab)[0][:24]
    eng, out = _run_seq(lambda: Engine(
        model, MemoryAccountant(m_total=256e6), max_slots=2, s_max=64,
        device="cpu"), Request, [prompt, prompt])
    assert eng._pc is None and eng.arena.prefix_index is None
    assert eng.arena.pages_aliased == 0
    assert all(r.prefill_avoided == 0 for r in out.values())
