"""The SSD scan's backward: the port's plain gradients against the JAX
package's.

Three gradients of the scan's (y, final state) are compared, on the same
numpy inputs and cotangents: ``jax.vjp`` of the reference's
``repro.models.mamba2._ssd_chunk_scan``; autograd of the port's plain scan
``ref.ssd_chunk_scan`` (what the CPU trains with); and ``ref.ssd_chunk_bwd``,
the backward kernel's algorithm written out (chunks of at most 64, a
ragged last one; ``csrc/ssd_chunk_bwd.cu`` is held against it on the card
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``). Tolerances: each
gradient's largest error over its largest magnitude below 1e-4 in float32
(sums in other orders and, against the kernel's chunking, other chunk
boundaries) and 1e-10 on a float64 copy (every float32 cast point of both
packages widened, as ``tests/test_torch_train.py`` does).

The reference takes exp over the whole chunk before masking it, so at the
configs' own chunk of 256 its gradient overflows to NaN; the port's plain
scan masks the exponent first. A pin below shows both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.mamba2 import _ssd_chunk_scan
from repro_torch.kernels import ops, ref


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch intra-op thread: test processes that each spin a pool of
    threads on a shared host slow one another down a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


NAMES = ("x", "dt", "A", "Bm", "Cm")
GRADS = ("dx", "ddt", "dA", "dB", "dC")


def _case(seed, B, S, H, P, N, dtype=np.float32, A=None):
    """The scan's inputs and both cotangents (dy, dstate), numpy."""
    rng = np.random.default_rng(seed)
    c = dict(
        x=rng.standard_normal((B, S, H, P)),
        dt=np.log1p(np.exp(rng.standard_normal((B, S, H)))),   # softplus
        A=(-np.exp(rng.standard_normal(H) * 0.3) if A is None
           else np.full(H, A)),
        Bm=rng.standard_normal((B, S, H, N)),
        Cm=rng.standard_normal((B, S, H, N)),
        dy=rng.standard_normal((B, S, H, P)),
        dstate=rng.standard_normal((B, H, N, P)))
    return {k: v.astype(dtype) for k, v in c.items()}


def _jax_grads(c, chunk, with_state):
    def f(*a):
        return _ssd_chunk_scan(*a, chunk)
    args = [jnp.asarray(c[k]) for k in NAMES]
    (y, st), vjp = jax.vjp(f, *args)
    dst = (jnp.asarray(c["dstate"]) if with_state
           else jnp.zeros_like(st))
    return [np.asarray(g) for g in vjp((jnp.asarray(c["dy"]), dst))]


def _autograd(c, chunk, with_state):
    ins = [torch.from_numpy(c[k]).requires_grad_() for k in NAMES]
    y, st = ref.ssd_chunk_scan(*ins, chunk)
    loss = (y * torch.from_numpy(c["dy"])).sum()
    if with_state:
        loss = loss + (st * torch.from_numpy(c["dstate"])).sum()
    return [g.detach().numpy() for g in torch.autograd.grad(loss, ins)]


def _kernel_algorithm(c, chunk, with_state):
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    return [g.numpy() for g in ref.ssd_chunk_bwd(
        *(t[k] for k in NAMES), t["dy"], t["dstate"] if with_state else None,
        chunk)]


def _errs(got, want):
    return {n: float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
            for n, g, w in zip(GRADS, got, want)}


def _widen(monkeypatch):
    """Every float32 cast point of both packages widened to float64."""
    monkeypatch.setattr(torch.Tensor, "float", torch.Tensor.double)
    monkeypatch.setattr(torch, "float32", torch.float64)
    monkeypatch.setattr(jnp, "float32", jnp.float64)


# (B, S, H, P, N, chunk, with the final state's gradient): B and H > 1,
# prime S, chunk < S (several chunks; the kernel's 64 and the reference's
# largest divisor differ) and chunk >= S (one chunk), N 16 and wider
CASES = [(2, 37, 3, 8, 16, 8, True), (2, 131, 2, 4, 16, 64, False),
         (1, 67, 2, 8, 32, 256, True), (2, 96, 2, 4, 40, 32, True)]
DTYPES = (np.float32, np.float64)
TOL = {np.float32: 1e-4, np.float64: 1e-10}


def _grads_pair(monkeypatch, case, dtype, other):
    """(the port's ``other`` gradients, the reference's), in ``dtype``."""
    B, S, H, P, N, chunk, with_state = case
    if dtype == np.float64:
        _widen(monkeypatch)
        with jax.enable_x64(True):
            c = _case(S, B, S, H, P, N, dtype)
            return other(c, chunk, with_state), \
                _jax_grads(c, chunk, with_state)
    c = _case(S, B, S, H, P, N, dtype)
    return other(c, chunk, with_state), _jax_grads(c, chunk, with_state)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_autograd_equals_jax_vjp(case, dtype, monkeypatch):
    got, want = _grads_pair(monkeypatch, case, dtype, _autograd)
    assert all(np.isfinite(w).all() for w in want)
    errs = _errs(got, want)
    assert max(errs.values()) <= TOL[dtype], errs


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("case", CASES, ids=str)
def test_kernel_algorithm_equals_jax_vjp(case, dtype, monkeypatch):
    """ref.ssd_chunk_bwd (the kernel's chunks of 64) against the reference;
    the same limits hold it against autograd of the plain scan, which
    equals the reference (the test above)."""
    got, want = _grads_pair(monkeypatch, case, dtype, _kernel_algorithm)
    errs = _errs(got, want)
    assert max(errs.values()) <= TOL[dtype], errs
    B, S, H, P, N, chunk, with_state = case
    c = _case(S, B, S, H, P, N, np.float32)
    if dtype == np.float32:
        errs = _errs(_kernel_algorithm(c, chunk, with_state),
                     _autograd(c, chunk, with_state))
        assert max(errs.values()) <= TOL[dtype], errs


def test_reference_gradient_overflows_where_the_port_does_not(monkeypatch):
    """S = 512 at the configs' chunk of 256, A = -1, dt = softplus(N(0,1))
    (about 0.8): the reference's exp above the diagonal reaches about
    exp(200), inf in float32, and its gradient multiplies the mask's 0 by
    it: NaN in ddt and dA. The port's plain scan masks the exponent first:
    finite, and in float64 (where nothing overflows at this length) equal
    to the gradient at chunk 64, the reference's and its own, to 1e-10."""
    shape = (1, 512, 2, 8, 8)
    c = _case(5, *shape, A=-1.0)
    jg = dict(zip(GRADS, _jax_grads(c, 256, False)))
    assert np.isnan(jg["ddt"]).any() and np.isnan(jg["dA"]).any()
    pg = _autograd(c, 256, False)
    assert all(np.isfinite(g).all() for g in pg)
    _widen(monkeypatch)
    with jax.enable_x64(True):
        c = _case(5, *shape, np.float64, A=-1.0)
        long_chunk = _autograd(c, 256, False)
        for want in (_jax_grads(c, 64, False), _autograd(c, 64, False)):
            errs = _errs(long_chunk, want)
            assert max(errs.values()) <= 1e-10, errs


def test_plain_forward_is_bitwise_the_exp_then_mask_form():
    """Masking the exponent before exp leaves the forward's bits as they
    were (exp(-inf) is 0 exactly): y and the final state equal a copy of
    the former exp-then-mask scan, at a length where nothing overflows."""
    c = _case(7, 2, 40, 3, 8, 16)
    args = [torch.from_numpy(c[k]) for k in NAMES]
    y, st = ref.ssd_chunk_scan(*args, 16)
    y0, st0 = _exp_then_mask_scan(*args, 16)
    assert torch.equal(y, y0) and torch.equal(st, st0)


def _exp_then_mask_scan(x, dt, A, Bm, Cm, chunk):
    """The plain scan as it was before the repair (exp, then where)."""
    B, S, H, P_ = x.shape
    N = Bm.shape[-1]
    Q = max(min(chunk, S), 1)
    while S % Q:
        Q -= 1
    iq = torch.arange(Q)
    causal = (iq[:, None] >= iq[None, :])[None, :, :, None]
    state = torch.zeros((B, H, N, P_), dtype=torch.float32)
    ys = []
    for c0 in range(0, S, Q):
        xc, dc = x[:, c0:c0 + Q].float(), dt.float()[:, c0:c0 + Q]
        bc, cc = Bm[:, c0:c0 + Q].float(), Cm[:, c0:c0 + Q].float()
        dA_cs = torch.cumsum(dc * A, dim=1)
        xdt = xc * dc[..., None]
        scores = torch.einsum("bqhn,bkhn->bqkh", cc, bc)
        L = torch.exp(dA_cs[:, :, None, :] - dA_cs[:, None, :, :])
        L = torch.where(causal, L, torch.zeros(()))
        y = torch.einsum("bqkh,bkhp->bqhp", scores * L, xdt)
        y = y + torch.einsum("bqhn,bhnp->bqhp",
                             cc * torch.exp(dA_cs)[..., None], state)
        decay_to_end = torch.exp(dA_cs[:, -1:, :] - dA_cs)
        state = (state * torch.exp(dA_cs[:, -1])[..., None, None]
                 + torch.einsum("bkhn,bkhp->bhnp",
                                bc * decay_to_end[..., None], xdt))
        ys.append(y)
    return torch.cat(ys, dim=1).to(x.dtype), state


def test_ops_counts_the_plain_backward_on_the_cpu():
    """Under grad on CPU tensors ops.ssd_chunk is the plain scan, counted
    as a plain forward, and as a plain backward when the backward runs
    (once, whichever outputs it flows through); without grad only the
    forward."""
    c = _case(3, 1, 20, 2, 4, 8)
    ops.reset_counts()
    args = [torch.from_numpy(c[k]).requires_grad_() for k in NAMES]
    with torch.enable_grad():
        y, state = ops.ssd_chunk(*args, 8)
        assert ops.plain_calls["ssd_chunk_bwd"] == 0
        (y.sum() + state.sum()).backward()
    assert all(a.grad is not None for a in args)
    assert ops.plain_calls["ssd_chunk"] == 1
    assert ops.plain_calls["ssd_chunk_bwd"] == 1
    with torch.no_grad():
        ops.ssd_chunk(*args, 8)
    assert ops.plain_calls["ssd_chunk_bwd"] == 1
    assert ops.counts()["launches"]["ssd_chunk_bwd"] == 0
    ops.reset_counts()
    assert not any(ops.plain_calls.values())
