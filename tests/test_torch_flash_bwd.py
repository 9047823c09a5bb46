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
        "simt": 0, "mma": 0}
    ops.reset_counts()
    assert ops.plain_calls["flash_attention_bwd"] == 0
