"""The flash backward's plain versions against autograd and the reference.

``ref.flash_attention_lse`` (attention and the row log-sum-exp) and
``ref.flash_attention_bwd_ref`` (dq, dk, dv from the output and lse, the
explicit formulas the CUDA backward computes) are held against autograd
through the port's ``ref.blockwise_attention`` and against ``jax.vjp`` of
the reference's ``layers.blockwise_attention`` (K/V repeated to the query
heads, as its ``attn_full`` does, so its dk and dv are summed over each kv
head's query heads here). Causal and non-causal, one and four query heads
per kv head, Sq != Sk, hd 64 and 128, ragged lengths; all in float32, to
2e-5 (sums in other orders over a few hundred keys). On the CPU,
``ops.flash_attention`` stays the plain version under grad, differentiated
by autograd; no kernel counter moves. The kernels themselves are held
against these on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch intra-op thread: test processes that each spin a pool of
    threads on a shared host slow one another down a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=0, atol=2e-5)
# (B, Sq, Sk, H, Hkv, hd, causal)
CASES = [
    (1, 40, 40, 4, 4, 64, True),
    (2, 37, 37, 8, 2, 64, True),       # g = 4, ragged
    (1, 24, 61, 4, 1, 128, False),     # cross, Sq != Sk, g = 4
    (2, 29, 29, 4, 4, 128, False),
    (1, 50, 23, 8, 2, 64, True),       # causal with Sk < Sq
    (1, 19, 70, 4, 4, 64, True),       # causal with Sk > Sq
    (1, 600, 600, 2, 1, 64, True),     # past one 512-row chunk
]


def _inputs(case, seed=0):
    B, Sq, Sk, H, Hkv, hd, _ = case
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return f(B, Sq, H, hd), f(B, Sk, Hkv, hd), f(B, Sk, Hkv, hd), \
        f(B, Sq, H, hd)


def _plain(q, k, v, dout, causal):
    t = [torch.from_numpy(a) for a in (q, k, v, dout)]
    o, lse = ref.flash_attention_lse(*t[:3], causal)
    return (o, lse), ref.flash_attention_bwd_ref(*t[:3], o, lse, t[3],
                                                 causal)


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_equals_autograd_of_blockwise_attention(case):
    causal = case[-1]
    q, k, v, dout = _inputs(case)
    (o, lse), grads = _plain(q, k, v, dout, causal)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    want = ref.blockwise_attention(tq, tk, tv, causal)
    want.backward(torch.from_numpy(dout))
    np.testing.assert_allclose(o.numpy(), want.detach().numpy(), **TOL)
    for got, t in zip(grads, (tq, tk, tv)):
        np.testing.assert_allclose(got.numpy(), t.grad.numpy(), **TOL)
    # lse: the log of each row's softmax denominator, in the scaled-score
    # domain
    s = torch.einsum("bqhd,bkhd->bhqk", tq.detach(),
                     ref._repeat_kv(tk.detach(), tv.detach(), q.shape[2])[0])
    s = s * q.shape[-1] ** -0.5
    if causal:
        mask = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool).tril()
        s = s.masked_fill(~mask, float("-inf"))
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(),
                               **TOL)


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_equals_the_references_vjp(case):
    B, Sq, Sk, H, Hkv, hd, causal = case
    q, k, v, dout = _inputs(case, seed=1)
    g = H // Hkv
    rep = lambda a: jnp.repeat(jnp.asarray(a), g, axis=2)  # noqa: E731
    o, vjp = jax.vjp(
        lambda q_, k_, v_: jlayers.blockwise_attention(q_, k_, v_, causal),
        jnp.asarray(q), rep(k), rep(v))
    jq, jk, jv = vjp(jnp.asarray(dout))
    # the reference's dk / dv are per query head: sum each kv head's g
    jk, jv = (np.asarray(a).reshape(B, Sk, Hkv, g, hd).sum(3)
              for a in (jk, jv))
    (po, _), (dq, dk, dv) = _plain(q, k, v, dout, causal)
    np.testing.assert_allclose(po.numpy(), np.asarray(o), **TOL)
    for got, want in ((dq, jq), (dk, jk), (dv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_the_cpu_dispatch_stays_plain_under_grad():
    q, k, v, dout = _inputs(CASES[1], seed=2)
    ops.reset_counts()
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = ops.flash_attention(*ts, causal=True)
    out.backward(torch.from_numpy(dout))
    got = [t.grad.clone() for t in ts]
    for t in ts:
        t.grad = None
    ref.blockwise_attention(*ts, True).backward(torch.from_numpy(dout))
    for a, t in zip(got, ts):
        assert torch.equal(a, t.grad)
    assert ops.plain_calls["flash_attention"] == 1
    assert ops.plain_calls["flash_attention_bwd"] == 1
    assert fa.launches == fa.lse_launches == fa.bwd_launches == 0
    # without grad the count of plain backward calls does not move
    with torch.no_grad():
        ops.flash_attention(*ts, causal=True)
    assert ops.plain_calls == {**ops.plain_calls, "flash_attention": 2,
                               "flash_attention_bwd": 1}
    counts = ops.counts()
    assert counts["launches"]["flash_attention_bwd"] == 0
    assert counts["launches_by_variant"]["flash_attention_bwd"] == {
        "simt": 0, "wgmma": 0}
    ops.reset_counts()
    assert ops.plain_calls["flash_attention_bwd"] == 0


# ------------------------------------- the wgmma kernel's tile plan, emulated
# csrc/flash_attention_bwd.cu's wgmma variant, written out tile by tile in
# torch: dkdv's blocks of 128 keys (two warpgroups of 64) walking the g query
# heads' 64-row tiles, the causal skip of tiles before a warpgroup's keys
# and the mask on its diagonal tile, rows past Sq all zeros (lse and D too);
# dq's blocks of 128 rows (two of 64) walking 64-key tiles up to their last
# visible key, masking past it. P and dS are exp2(S scale log2 e - lse
# log2 e) and P (dP - D) in f32; with ``bf16`` they are rounded to bf16 for
# their products (P^T dO, dS^T Q, dS K) and the outputs on the store, as on
# the card. Rows and keys past the tensors are zero padding, as TMA fills.
LOG2E = 1.4426950408889634


def _rows(t, r0, n):
    """Rows r0 .. r0 + n - 1 of t's first dimension, padded with zeros."""
    out = torch.zeros((n, *t.shape[1:]), dtype=t.dtype)
    got = t[r0:r0 + n]
    out[:got.shape[0]] = got
    return out


def _wgmma_plan(q, k, v, o, lse, dout, causal, bf16=False):
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g, scale = H // Hkv, hd ** -0.5
    rnd = ((lambda t: t.to(torch.bfloat16).float()) if bf16
           else (lambda t: t))
    delta = (dout * o).sum(-1)                       # [B, Sq, H]
    dq, dk, dv = (torch.zeros_like(t) for t in (q, k, v))
    for b in range(B):
        for kvh in range(Hkv):
            for k0 in range(0, Sk, 128):             # pass 1: a dkdv block
                for kw in (k0, k0 + 64):             # its two warpgroups
                    K, V = (_rows(t[b, :, kvh], kw, 64) for t in (k, v))
                    acc_k, acc_v = torch.zeros(64, hd), torch.zeros(64, hd)
                    for h in range(kvh * g, kvh * g + g):
                        for q0 in range(k0 if causal else 0, Sq, 64):
                            if causal and q0 + 64 <= kw:
                                continue             # no query sees a key
                            Q, dO = (_rows(t[b, :, h], q0, 64)
                                     for t in (q, dout))
                            lt = _rows(lse[b, h], q0, 64)
                            dd = _rows(delta[b, :, h], q0, 64)
                            st, dpt = K @ Q.T, V @ dO.T   # keys x queries
                            pt = torch.exp2(st * scale * LOG2E
                                            - lt[None, :] * LOG2E)
                            if causal and q0 == kw:  # the diagonal tile
                                pt = pt.masked_fill(
                                    torch.ones(64, 64, dtype=torch.bool)
                                    .triu(1).T, 0.0)
                            dst = pt * (dpt - dd[None, :])
                            acc_v += rnd(pt) @ dO
                            acc_k += rnd(dst) @ Q
                    n = min(64, Sk - kw)
                    if n > 0:
                        dk[b, kw:kw + n, kvh] = rnd(acc_k[:n] * scale)
                        dv[b, kw:kw + n, kvh] = rnd(acc_v[:n])
        for h in range(H):
            kvh = h // g
            for q0 in range(0, Sq, 128):             # pass 2: a dq block
                k_end = min(q0 + 128, Sk) if causal else Sk
                for qw in (q0, q0 + 64):
                    Q, dO = (_rows(t[b, :, h], qw, 64) for t in (q, dout))
                    lt = _rows(lse[b, h], qw, 64)
                    dd = _rows(delta[b, :, h], qw, 64)
                    rows = torch.arange(qw, qw + 64)
                    last = (rows.clamp(max=Sk - 1) if causal
                            else torch.full((64,), Sk - 1))
                    wg_last = min(qw + 63, Sk - 1) if causal else Sk - 1
                    acc = torch.zeros(64, hd)
                    for kt0 in range(0, k_end, 64):
                        if kt0 > wg_last:
                            continue                 # past every row's keys
                        K, V = (_rows(t[b, :, kvh], kt0, 64) for t in (k, v))
                        s, dp = Q @ K.T, dO @ V.T
                        p = torch.exp2(s * scale * LOG2E
                                       - lt[:, None] * LOG2E)
                        keys = torch.arange(kt0, kt0 + 64)
                        p = p.masked_fill(keys[None, :] > last[:, None], 0.0)
                        acc += rnd(p * (dp - dd[:, None])) @ K
                    n = min(64, Sq - qw)
                    if n > 0:
                        dq[b, qw:qw + n, h] = rnd(acc[:n] * scale)
    return dq, dk, dv


# (B, Sq, Sk, H, Hkv, hd, causal): several dkdv and dq blocks, ragged edges
PLAN_CASES = [
    (1, 150, 150, 4, 1, 64, True),     # g = 4, a second key block
    (2, 70, 131, 2, 2, 128, False),    # g = 1, Sq < Sk
    (1, 200, 97, 4, 2, 64, True),      # causal with Sk < Sq
    (1, 40, 129, 2, 1, 64, True),      # Sq < 64, causal with Sk > Sq
    (1, 257, 129, 4, 4, 128, False),   # Sq > Sk, one row into a third block
]


@pytest.mark.parametrize("case", PLAN_CASES)
def test_wgmma_tile_plan_equals_the_references_vjp(case):
    """In f32 the tile plan is the reference's gradient to 1e-5."""
    B, Sq, Sk, H, Hkv, hd, causal = case
    q, k, v, dout = _inputs(case, seed=3)
    g = H // Hkv
    rep = lambda a: jnp.repeat(jnp.asarray(a), g, axis=2)  # noqa: E731
    _, vjp = jax.vjp(
        lambda q_, k_, v_: jlayers.blockwise_attention(q_, k_, v_, causal),
        jnp.asarray(q), rep(k), rep(v))
    jq, jk, jv = vjp(jnp.asarray(dout))
    jk, jv = (np.asarray(a).reshape(B, Sk, Hkv, g, hd).sum(3)
              for a in (jk, jv))
    t = [torch.from_numpy(a) for a in (q, k, v, dout)]
    o, lse = ref.flash_attention_lse(*t[:3], causal)
    got = _wgmma_plan(*t[:3], o, lse, t[3], causal)
    for a, want in zip(got, (jq, jk, jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)


def _row_scaled_err(got, want):
    """Each row's largest error over the larger of its own magnitude and 1%
    of the tensor's: what tests/test_torch_cuda.py and chip_smoke.py hold
    the card's bf16 backward to (3e-2)."""
    diff = (got - want).abs()
    floor = 1e-2 * float(want.abs().max())
    return float((diff.amax(-1) / want.abs().amax(-1).clamp_min(floor))
                 .max())


@pytest.mark.parametrize("case", PLAN_CASES)
def test_wgmma_tile_plan_rounding_meets_the_card_limits(case):
    """With the kernel's bf16 inputs, o, roundings of P^T, dS^T and dS and
    bf16 outputs, the plan stays within the card's limits of the f32 plain
    backward on the same values: 3e-2 of each row's magnitude and 5e-2
    absolute."""
    causal = case[-1]
    q, k, v, dout = (torch.from_numpy(a).to(torch.bfloat16).float()
                     for a in _inputs(case, seed=4))
    o, lse = ref.flash_attention_lse(q, k, v, causal)
    o = o.to(torch.bfloat16).float()            # the forward's bf16 output
    got = _wgmma_plan(q, k, v, o, lse, dout, causal, bf16=True)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, dout, causal)
    for a, w in zip(got, want):
        assert float((a - w).abs().max()) <= 5e-2
        assert _row_scaled_err(a, w) <= 3e-2
