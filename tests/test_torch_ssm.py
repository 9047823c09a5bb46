"""The port's Mamba2 (SSM) path against the JAX package.

The SSD scan's plain versions take the same numpy inputs as the JAX oracle
``ssd_chunk_ref`` (the exact sequential recurrence), the Pallas kernel in
interpret mode and the reference model's ``_ssd_chunk_scan``; the reduced
mamba2-2.7b takes the JAX model's weights through ``params_from_jax``.
Tolerances: the largest error over the largest magnitude below 5e-4
against the oracle and the Pallas kernel (``tests/test_kernels.py``'s
bound for a chunked scan against a sequential one); 2e-4 on ``y`` and 1e-5
on the final state against ``_ssd_chunk_scan`` (the same chunked
operations); 1e-4 on float32 logits. Engine tokens must be identical.

The SSD kernel's wgmma variant rounds its operands to bf16 where its
tensor-core products need them; a plain-torch emulation of that rounding
plan is held here against the plain version and the JAX scan under the
limits the card holds the kernel to (``chip_smoke.py``,
``tests/test_torch_cuda.py``): y 1e-2 of its magnitude (overall and per
head), the final state 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as jax_config
from repro.core.runtime.accounting import MemoryAccountant as JaxAccountant
from repro.kernels import ref as jref
from repro.kernels.ssd_chunk import ssd_chunk as pl_ssd
from repro.models import build_model as jax_build
from repro.models.mamba2 import _ssd_chunk_scan
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.runtime.accounting import MemoryAccountant
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_chunk as ssd
from repro_torch.models import build_model, init_params
from repro_torch.serving.engine import Engine, Request

NAME = "mamba2-2.7b"
ATOL = dict(rtol=0, atol=1e-4)


def _ssd_case(seed, B, S, H, P, N):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.standard_normal((B, S, H, P), np.float32),
        dt=np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(
            np.float32),                                     # softplus
        A=(-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32),
        Bm=rng.standard_normal((B, S, H, N), np.float32),
        Cm=rng.standard_normal((B, S, H, N), np.float32))


def _args(c, mod):
    conv = torch.from_numpy if mod is torch else jnp.asarray
    return [conv(c[k]) for k in ("x", "dt", "A", "Bm", "Cm")]


def _scaled_err(got, exp) -> float:
    got, exp = np.asarray(got, np.float32), np.asarray(exp, np.float32)
    return float(np.abs(got - exp).max() / (np.abs(exp).max() + 1e-9))


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_config(NAME).reduced()
    jm = jax_build(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    cfg = get_config(NAME).reduced()
    model = build_model(cfg, params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu"), device="cpu")
    return jm, jparams, model


# ------------------------------------------------------------------ config
def test_config_matches_reference():
    jcfg, cfg = jax_config(NAME), get_config(NAME)
    for c, j in ((cfg, jcfg), (cfg.reduced(), jcfg.reduced())):
        for f in dataclasses.fields(c):
            if f.name == "ssm":
                assert dataclasses.asdict(c.ssm) == dataclasses.asdict(j.ssm)
            elif f.name != "dtype":
                assert getattr(c, f.name) == getattr(j, f.name), f.name
        assert c.param_count() == j.param_count()
        assert c.ssm_state_bytes() == j.ssm_state_bytes()
        assert c.kv_bytes_per_token() == j.kv_bytes_per_token() == 0
        assert c.n_attn_layers == j.n_attn_layers == 0
    assert cfg.ssm.n_heads(cfg.d_model) == 80 and cfg.ssm.d_inner(2560) == 5120
    assert cfg.dtype == torch.bfloat16 and cfg.reduced().dtype == torch.float32


def test_init_params_matches_reference_layout_dtypes_and_scale():
    cfg = get_config(NAME).reduced()
    jm = jax_build(jax_config(NAME).reduced())
    conv = params_from_jax(jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0))), cfg, device="cpu")
    ours = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    flat_c = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(conv)[0]}
    flat_o = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(ours)[0]}
    assert flat_c.keys() == flat_o.keys()
    for k, t in flat_o.items():
        ref_t = flat_c[k]
        assert t.shape == ref_t.shape and t.dtype == ref_t.dtype, k
        if bool((ref_t == ref_t.flatten()[0]).all()):   # ones / zeros leaf
            assert torch.equal(t, ref_t), k
        else:
            scale = 0.5 if k.endswith("['conv']") else 1.0
            fan_in = t.shape[-2] if t.dim() >= 2 else t.shape[-1]
            assert abs(float(t.std()) * fan_in ** 0.5 / scale - 1) < 0.15, k


def test_params_from_jax_keeps_the_float32_leaves_under_bf16():
    """A bf16 tree converts (its numpy leaves are ml_dtypes.bfloat16, which
    torch.from_numpy refuses), and the SSM's float32 leaves stay float32."""
    jcfg = dataclasses.replace(jax_config(NAME).reduced(), dtype=jnp.bfloat16)
    cfg = dataclasses.replace(get_config(NAME).reduced(),
                              dtype=torch.bfloat16)
    jparams = jax_build(jcfg).init(jax.random.PRNGKey(1))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    # bfloat16 leaves arrive bit for bit (numpy holds them as ml_dtypes)
    assert params["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(params["embed"].float().numpy(),
                                  np.asarray(jparams["embed"], np.float32))
    for layer in params["layers"]:
        for k, t in layer["ssm"].items():
            want = (torch.float32 if k in ("A_log", "dt_bias", "D_skip")
                    else torch.bfloat16)
            assert t.dtype == want, k
    ours = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert ours["layers"][0]["ssm"]["A_log"].dtype == torch.float32
    assert ours["layers"][0]["ssm"]["wx"].dtype == torch.bfloat16


# ---------------------------------------------------------------- SSD scan
@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (2, 128, 4, 32, 16, 32),
    (1, 64, 2, 16, 8, 16),
    (2, 96, 8, 64, 32, 32),     # non-pow2 seq / chunk interplay
    (1, 67, 4, 16, 16, 32),     # prime S
])
def test_ssd_plain_versions_match_jax_oracle_and_pallas(B, S, H, P, N, chunk):
    c = _ssd_case(0, B, S, H, P, N)
    y, state = ref.ssd_chunk_scan(*_args(c, torch), chunk)
    exp = np.asarray(jref.ssd_chunk_ref(*_args(c, jnp)))
    assert _scaled_err(y, exp) < 5e-4
    pallas = pl_ssd(*_args(c, jnp), chunk=chunk, block_heads=2,
                    interpret=True)
    assert _scaled_err(y, pallas) < 5e-4
    seq = ref.ssd_chunk_ref(*_args(c, torch))
    np.testing.assert_allclose(seq.numpy(), exp, rtol=1e-5, atol=1e-5)
    assert state.shape == (B, H, N, P) and state.dtype == torch.float32


@pytest.mark.parametrize("S,chunk", [(128, 32), (96, 64), (67, 32), (1, 256)])
def test_ssd_plain_version_mirrors_the_model_scan(S, chunk):
    c = _ssd_case(1, 2, S, 4, 32, 16)
    y, state = ref.ssd_chunk_scan(*_args(c, torch), chunk)
    jy, jstate = _ssd_chunk_scan(*_args(c, jnp), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), rtol=1e-5,
                               atol=1e-5)


def test_ops_dispatch_ssd_on_cpu_tensors_to_the_plain_version():
    c = _ssd_case(2, 1, 40, 4, 16, 8)
    ops.reset_counts()
    y, state = ops.ssd_chunk(*_args(c, torch), 32)
    want_y, want_state = ref.ssd_chunk_scan(*_args(c, torch), 32)
    assert torch.equal(y, want_y) and torch.equal(state, want_state)
    assert ops.plain_calls["ssd_chunk"] == 1 and ssd.launches == 0
    with pytest.raises(ValueError, match="CUDA"):
        ssd.ssd_chunk(*_args(c, torch), 32)


# ------------------------------------------ the wgmma kernel's rounding plan
def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _products(a: torch.Tensor, split: bool):
    """An f32 operand as the kernel feeds it to bf16 products: hi, and
    with ``split`` also lo = bf16(a - hi), each product summed in f32."""
    hi = _bf16(a)
    return (hi, _bf16(a - hi)) if split else (hi,)


def _ssd_wgmma_plan(x, dt, A, Bm, Cm, split_xw: bool = True,
                    split_g: bool = True, Q: int = 64):
    """The arithmetic of ``csrc/ssd_chunk.cu``'s wgmma variant in plain
    torch: fixed chunks of 64 with the ragged last one padded by dt = 0
    rows; per chunk G = C B^T; y = exp(cs_q) C bf16(state) + (G o L o dt) x
    with G o L o dt split hi + lo; state = exp(cs_end) state + B^T (x o w)
    with x o w split hi + lo; sums in f32, y rounded to x's dtype. The
    kernel's split of P over warpgroups (64 columns each) changes no sum,
    so it is not repeated here. -> (y, final state f32)."""
    B, S, H, P = x.shape
    pad = (-S) % Q

    def padded(t):
        return F.pad(t.float(), (0, 0) * (t.dim() - 2) + (0, pad))

    xp, bp, cp, dp = padded(x), padded(Bm), padded(Cm), padded(dt)
    iq = torch.arange(Q)
    causal = iq[:, None] >= iq[None, :]
    state = torch.zeros((B, H, Bm.shape[-1], P))
    ys = []
    for c0 in range(0, S + pad, Q):
        xc, bc, cc = (t[:, c0:c0 + Q] for t in (xp, bp, cp))
        dc = dp[:, c0:c0 + Q]                               # [B, Q, H]
        cs = torch.cumsum(dc * A, dim=1).transpose(1, 2)    # [B, H, Q]
        decay = torch.where(causal, torch.exp(torch.where(
            causal, cs[..., :, None] - cs[..., None, :], 0.)), 0.)
        g = (torch.einsum("bqhn,bkhn->bhqk", cc, bc) * decay
             * dc.transpose(1, 2)[:, :, None, :])
        y = (torch.einsum("bqhn,bhnp->bqhp", cc, _bf16(state))
             * torch.exp(cs).transpose(1, 2)[..., None])
        for part in _products(g, split_g):
            y = y + torch.einsum("bhqk,bkhp->bqhp", part, xc)
        ys.append(y)
        w = dc * torch.exp(cs[..., -1:] - cs).transpose(1, 2)
        state = state * torch.exp(cs[..., -1])[..., None, None]
        for part in _products(xc * w[..., None], split_xw):
            state = state + torch.einsum("bkhn,bkhp->bhnp", bc, part)
    return torch.cat(ys, dim=1)[:, :S].to(x.dtype), state


def _ssd_bf16_case(seed, S, H=3):
    """mamba2-2.7b's head widths (P 64, N 128); x, B and C in bf16."""
    c = _ssd_case(seed, 1, S, H, 64, 128)
    x, dt, A, Bm, Cm = _args(c, torch)
    return x.bfloat16(), dt, A, Bm.bfloat16(), Cm.bfloat16()


def _head_err(got, exp) -> float:
    got, exp = np.asarray(got, np.float32), np.asarray(exp, np.float32)
    return float((np.abs(got - exp).max(axis=(0, 1, 3))
                  / np.abs(exp).max(axis=(0, 1, 3))).max())


@pytest.mark.parametrize("S", [13, 64, 65, 200])
def test_ssd_wgmma_rounding_plan_meets_the_card_limits(S):
    args = _ssd_bf16_case(3, S)
    y, state = _ssd_wgmma_plan(*args)
    want_y, want_state = ref.ssd_chunk_scan(*args, 256)
    jy, jstate = _ssd_chunk_scan(*(jnp.asarray(a.float().numpy())
                                   for a in args), chunk=256)
    for ry, rs in ((want_y.float(), want_state), (jy, jstate)):
        assert _scaled_err(y.float(), ry) <= 1e-2
        assert _head_err(y.float(), ry) <= 1e-2
        assert _scaled_err(state, rs) <= 1e-4


def test_ssd_single_bf16_state_update_breaks_the_state_limit():
    """Without the hi + lo split of x o w the state misses 1e-4 by an order
    of magnitude (one bf16 rounding per term); with it, it is ~100 times
    inside."""
    args = _ssd_bf16_case(4, 200)
    _, want = ref.ssd_chunk_scan(*args, 256)
    _, single = _ssd_wgmma_plan(*args, split_xw=False)
    _, split = _ssd_wgmma_plan(*args)
    assert _scaled_err(single, want) > 5e-4
    assert _scaled_err(split, want) < 1e-5


# ------------------------------------------------------------------- model
def test_prefill_and_two_decode_steps_match(pair):
    jm, jparams, model = pair
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 512, (2, 37)).astype(np.int32)
    jlogits, jcache = jm.prefill(jparams, jnp.asarray(toks))
    logits, k, v, state = model.prefill_with_state(torch.from_numpy(toks))
    assert k is None and v is None
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **ATOL)
    for name in ("state", "conv"):
        np.testing.assert_allclose(state[name].numpy(),
                                   np.asarray(jcache["slot0"][name]), **ATOL)
    cache = {n: t.clone() for n, t in state.items()}
    pos = np.full(2, 37, np.int32)
    for _ in range(2):
        nxt = rng.integers(0, 512, (2, 1)).astype(np.int32)
        jl, jcache = jm.decode_step(jparams, jcache, jnp.asarray(nxt),
                                    jnp.asarray(pos))
        got = model.decode_step(cache, torch.from_numpy(nxt),
                                torch.from_numpy(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(jl), **ATOL)
        for name in ("state", "conv"):
            np.testing.assert_allclose(cache[name].numpy(),
                                       np.asarray(jcache["slot0"][name]),
                                       **ATOL)
        pos = pos + 1


@pytest.mark.parametrize("n", [1, 2, 5])
def test_prefill_then_decode_equals_a_longer_prefill(pair, n):
    """Prompts shorter than the conv window included: the decode cache's
    conv tail is zero-padded in front, as the causal conv reads it."""
    _, _, model = pair
    toks = torch.from_numpy(np.random.default_rng(n).integers(
        0, 512, (1, n + 1)).astype(np.int32))
    _, _, _, cache = model.prefill_with_state(toks[:, :n])
    got = model.decode_step(cache, toks[:, n:], torch.tensor([n]))
    want, _, _ = model.prefill(toks)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_model_support_flags_and_layout(pair):
    _, _, model = pair
    assert not model.supports_chunked_prefill
    assert not model.supports_decode_horizon
    assert not model.supports_prefix_reuse
    assert model.paged_kv_layout()[0] == 0
    cache = model.state_cache(3)
    s = model.cfg.ssm
    assert cache["state"].shape == (2, 3, 16, s.d_state, s.head_dim)
    assert cache["conv"].shape == (2, 3, s.conv_dim - 1, 256)
    with pytest.raises(NotImplementedError):
        model.prefill_chunk(None, None, None, None, None, None, None, None,
                            ops.chunk_prefill_attention)


# ------------------------------------------------------------------ engine
def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, 512, p)]
            for p in (3, 7, 12, 5, 9, 14)]


@pytest.mark.parametrize("chunk,horizon", [(0, 1), (8, 8)])
def test_engine_greedy_tokens_and_state_bytes_match_jax(pair, chunk,
                                                        horizon):
    jm, jparams, model = pair
    prompts = _prompts()
    jacc = JaxAccountant(m_total=512e6)
    jeng = JaxEngine(jm, jparams, jacc, max_slots=3, s_max=64,
                     kv_backend="ref", prefill_chunk_tokens=chunk,
                     decode_horizon=horizon)
    acc = MemoryAccountant(m_total=512e6)
    eng = Engine(model, acc, max_slots=3, s_max=64, device="cpu",
                 prefill_chunk_tokens=chunk, decode_horizon=horizon)
    assert eng.chunk_tokens == jeng.chunk_tokens == 0
    assert eng.horizon == jeng.horizon == 1 and not eng.paged
    assert eng._state_bytes == jeng._state_bytes > 0
    assert acc.ctx == jacc.ctx == {f"{NAME}-smoke::decode-state":
                                   eng._state_bytes}
    for i, p in enumerate(prompts):
        jeng.submit(JaxRequest(req_id=i, tokens=list(p), max_new=10))
        eng.submit(Request(req_id=i, tokens=list(p), max_new=10))
    want = {r.req_id: r.out for r in jeng.drain()}
    got = {r.req_id: r.out for r in eng.drain()}
    assert got == want
    counters = ("stat_decode_syncs", "stat_horizon_steps", "stat_fused_steps",
                "stat_prefill_tokens", "stat_decode_tokens", "stat_steps")
    assert ([getattr(eng, c) for c in counters]
            == [getattr(jeng, c) for c in counters])
    assert eng.stat_horizon_steps == 0
    assert eng.arena.planes == {} and eng.arena.check_mirror()
    assert eng.arena.mapped_pages() == 0
    eng.release_kv()
    assert eng.cache is None and eng._state_bytes == 0 and acc.ctx == {}


def test_engine_release_kv_requeues_and_replays_identically(pair):
    _, _, model = pair
    prompts = _prompts(1)[:2]
    acc = MemoryAccountant(m_total=512e6)
    eng = Engine(model, acc, max_slots=2, s_max=64, device="cpu")
    for i, p in enumerate(prompts):
        eng.submit(Request(req_id=i, tokens=list(p), max_new=6))
    eng.step()
    eng.step()
    eng.release_kv()
    assert not eng.active and len(eng.waiting) == 2 and acc.ctx == {}
    assert [r.req_id for r in eng.waiting] == [0, 1]
    got = {r.req_id: r.out for r in eng.drain()}
    assert acc.ctx and eng.arena.mapped_pages() == 0
    fresh = Engine(model, MemoryAccountant(m_total=512e6), max_slots=2,
                   s_max=64, device="cpu")
    for i, p in enumerate(prompts):
        fresh.submit(Request(req_id=i, tokens=list(p), max_new=6))
    assert got == {r.req_id: r.out for r in fresh.drain()}
