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

The kernel's ``wgmma`` variant (bf16, chunks of 64) is emulated here in
plain torch: every product in f32 with one operand exact in bf16 and the
other, when f32, split into bf16 hi + lo (``_wgmma_emulation``), its two
chains of chunk states run by blocks that take ordered tickets and wait on
flags (``_run_blocks``). The emulation is held to ``ref.ssd_chunk_bwd`` at
the card's limits, and any admissible order of the blocks gives its bits.
"""
import random
import sys
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.mamba2 import _ssd_chunk_scan
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_chunk as ssd


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


# ------------------------------------------------ the wgmma variant, emulated
Q64 = 64
LOG2E = 1.4426950408889634


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _split(t):
    """An f32 operand as the kernel feeds it to the tensor cores: bf16 hi
    and lo, hi + lo = t to about 2^-17."""
    hi = _bf16(t)
    return hi, _bf16(t - hi)


def _split_mm(a, b, t_a=False):
    """a @ b (a.T @ b with ``t_a``) with a split: two products of bf16
    operands summed in f32."""
    hi, lo = _split(a)
    if t_a:
        hi, lo = hi.T, lo.T
    return hi @ b + lo @ b


def _mm_split(a, b_t):
    """a @ b_t.T with b_t split."""
    hi, lo = _split(b_t)
    return a @ hi.T + a @ lo.T


class _Chunk:
    """One block's inputs: chunk c of (b, h), padded to 64 rows (zeros, dt
    0: weight 0, decay 1), and its scalars, cs in log2 units as the kernel
    keeps it."""

    def __init__(self, t, b, h, c):
        S = t["x"].shape[1]
        c0 = c * Q64
        self.n = min(Q64, S - c0)
        sl = slice(c0, c0 + self.n)

        def pad(v):
            out = torch.zeros((Q64,) + tuple(v.shape[1:]),
                              dtype=torch.float32)
            out[:self.n] = v
            return out
        self.x, self.dy = pad(t["x"][b, sl, h]), pad(t["dy"][b, sl, h])
        self.B, self.C = pad(t["Bm"][b, sl, h]), pad(t["Cm"][b, sl, h])
        self.dt = pad(t["dt"][b, sl, h])
        self.a = t["A"][h]
        cs = torch.cumsum(self.dt * (self.a * LOG2E), 0)
        self.cs, cend = cs, cs[-1]
        self.eq, self.de = torch.exp2(cs), torch.exp2(cend - cs)
        self.w, self.e_end = self.dt * self.de, torch.exp2(cend)

    def inc(self):
        """The state's increment, [P][N]: (x o w)^T B, x o w split."""
        return _split_mm(self.x * self.w[:, None], self.B, t_a=True)

    def dinc(self):
        """The state gradient's increment, [P][N]: (dy o e)^T C."""
        return _split_mm(self.dy * self.eq[:, None], self.C, t_a=True)

    def grads(self, s_in, ds_out):
        """dx, ddt, dB, dC of the chunk's n rows and its share of dA, from
        s_in and ds_out ([P][N] f32), as chunk_wgmma computes them."""
        q = torch.arange(Q64)
        vis = q[:, None] >= q[None, :]
        L = torch.where(vis, torch.exp2(torch.where(
            vis, self.cs[:, None] - self.cs[None, :], torch.zeros(()))),
            torch.zeros(()))
        M = (self.C @ self.B.T) * L
        dM = (self.dy @ self.x.T) * self.dt[None, :] * vis
        dG = dM * L
        rsum, csum = (dM * M).sum(1), (dM * M).sum(0)
        W = _mm_split(self.dy, s_in.T)                     # dy s_in^T
        inter = self.eq * (self.C * W).sum(1)
        dC = self.eq[:, None] * W + _split_mm(dG, self.B)
        Z = self.de[:, None] * _mm_split(self.B, ds_out)  # B ds_out
        r2 = (Z * self.x).sum(1)
        dxdt = Z + _split_mm(M, self.dy, t_a=True)
        r12 = (dxdt * self.x).sum(1)
        dB = (self.w[:, None] * _mm_split(self.x, ds_out.T)
              + _split_mm(dG, self.C, t_a=True))
        hi, lo = _split(ds_out)
        dot = (s_in * (hi + lo)).sum()
        wv = self.dt * r2
        dcs = rsum - csum + inter - wv
        dcs[self.n - 1] += wv.sum() + self.e_end * dot
        da = torch.flip(torch.cumsum(torch.flip(dcs, [0]), 0), [0])
        n = self.n
        return (_bf16(self.dt[:, None] * dxdt)[:n],
                (da * self.a + r12)[:n], _bf16(dB)[:n], _bf16(dC)[:n],
                (da * self.dt).sum())


def _run_blocks(t, order_seed=None, resident=4):
    """The two chain launches as blocks that take ordered tickets (chunk
    order, then reverse chunk order) and wait on their predecessor's flag.
    With ``order_seed`` None the blocks run one after another in ticket
    order; otherwise at most ``resident`` blocks are in flight, and at each
    step a random one of them moves on if it is not waiting. Every block
    computes its increment before it waits, as the kernel does. Returns
    (dx, ddt, dA, dB, dC) and the largest number of blocks that waited at
    once."""
    B, S, H, P = t["x"].shape
    N = t["Bm"].shape[-1]
    nc, nbh = -(-S // Q64), B * H
    s_in = {(bh, 0): torch.zeros((P, N)) for bh in range(nbh)}
    ds = {}
    out = {"dx": torch.zeros((B, S, H, P)), "ddt": torch.zeros((B, S, H)),
           "dB": torch.zeros((B, S, H, N)), "dC": torch.zeros((B, S, H, N))}
    shares = torch.zeros((B, nc, H))

    def states_block(ticket):
        c, bh = divmod(ticket, nbh)
        ch = _Chunk(t, bh // H, bh % H, c)
        inc = ch.inc()
        while (bh, c) not in s_in:
            yield
        s_in[(bh, c + 1)] = ch.e_end * s_in[(bh, c)] + inc

    def chunk_block(ticket):
        level, bh = divmod(ticket, nbh)
        c, b, h = nc - 1 - level, bh // H, bh % H
        ch = _Chunk(t, b, h, c)
        dinc = ch.dinc()
        if c == nc - 1:
            ds[(bh, c)] = (t["dstate"][b, h].T.clone()
                           if t["dstate"] is not None else torch.zeros(P, N))
        while (bh, c) not in ds:
            yield
        ds[(bh, c - 1)] = ch.e_end * ds[(bh, c)] + dinc
        g = ch.grads(s_in[(bh, c)], ds[(bh, c)])
        sl = slice(c * Q64, c * Q64 + ch.n)
        for k, v in zip(("dx", "ddt", "dB", "dC"), g):
            out[k][b, sl, h] = v
        shares[b, c, h] = g[4]

    rng = random.Random(order_seed)
    most_waiting = 0
    for make, n_blocks in ((states_block, (nc - 1) * nbh),
                           (chunk_block, nc * nbh)):
        if order_seed is None:
            for ticket in range(n_blocks):
                for _ in make(ticket):
                    raise AssertionError("a block waited in ticket order")
            continue
        running, next_ticket = [], 0
        while running or next_ticket < n_blocks:
            if next_ticket < n_blocks and (len(running) < resident
                                           and rng.random() < 0.5
                                           or not running):
                running.append(make(next_ticket))
                next_ticket += 1
                continue
            blk = rng.choice(running)
            try:
                next(blk)
            except StopIteration:
                running.remove(blk)
            most_waiting = max(most_waiting, len(running))
    dA = torch.zeros(H)
    for i in range(B * nc):       # dA_kernel's order
        dA += shares.reshape(B * nc, H)[i]
    return (out["dx"], out["ddt"], dA, out["dB"], out["dC"]), most_waiting


def _bf16_case(case):
    """A case's inputs with x, B, C and dy rounded to bf16 (exact bf16
    values in f32, as the kernel reads them), torch f32."""
    B, S, H, P, N, chunk, with_state = case
    c = _case(S, B, S, H, P, N)
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    for k in ("x", "Bm", "Cm", "dy"):
        t[k] = _bf16(t[k])
    if not with_state:
        t["dstate"] = None
    return t


def _card_errors(got, want):
    """Each gradient's largest error over the tensor's magnitude, and its
    largest row error over the larger of the row's magnitude and 1% of the
    tensor's (the card's checks, ``chip_smoke.grad_errors``)."""
    out = {}
    for name, g, w in zip(GRADS, got, want):
        diff = (g - w).abs()
        top = float(w.abs().max())
        row = diff.amax(-1) / w.abs().amax(-1).clamp_min(max(1e-2 * top,
                                                             1e-30))
        out[name] = (float(diff.max()) / max(top, 1e-30), float(row.max()))
    return out


# bf16 outputs within 1e-2 of the tensor's magnitude and 3e-2 of a row's;
# the f32 ddt and dA within 1e-4 and 1e-3: the card's limits
CARD_LIMITS = {"dx": (1e-2, 3e-2), "dB": (1e-2, 3e-2), "dC": (1e-2, 3e-2),
               "ddt": (1e-4, 1e-3), "dA": (1e-4, 1e-3)}


@pytest.mark.parametrize("case", CASES[:3] + [(2, 130, 2, 8, 16, 64, True)],
                         ids=str)
def test_wgmma_emulation_is_within_the_card_limits(case):
    """The wgmma variant's products and chains, emulated with split-bf16
    operands and f32 sums, against the plain backward in f32 on the same
    bf16-exact inputs at the kernel's chunks of 64. (The emulation's own
    widths are the case's: its arithmetic does not depend on them.)"""
    t = _bf16_case(case)
    got, _ = _run_blocks(t)
    want = ref.ssd_chunk_bwd(t["x"], t["dt"], t["A"], t["Bm"], t["Cm"],
                             t["dy"], t["dstate"], 64)
    errs = _card_errors(got, want)
    for name, (e_abs, e_row) in errs.items():
        lim_abs, lim_row = CARD_LIMITS[name]
        assert e_abs <= lim_abs and e_row <= lim_row, errs


def test_wgmma_emulation_splits_its_f32_operands(monkeypatch):
    """A witness that the split matters: the same emulation with every f32
    operand rounded once to bf16 (no lo part) misses ddt's limit, which the
    split keeps (the test above)."""
    t = _bf16_case((2, 130, 2, 8, 16, 64, True))
    want = ref.ssd_chunk_bwd(t["x"], t["dt"], t["A"], t["Bm"], t["Cm"],
                             t["dy"], t["dstate"], 64)
    monkeypatch.setattr(sys.modules[__name__], "_split",
                        lambda v: (_bf16(v), torch.zeros_like(v)))
    rounded, _ = _run_blocks(t)
    errs = _card_errors(rounded, want)
    assert errs["ddt"][0] > CARD_LIMITS["ddt"][0], errs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chains_in_a_shuffled_ticket_order_give_the_ordered_bits(seed):
    """Blocks admitted in ticket order but run in a random interleaving,
    at most three in flight (fewer than the two sequences' heads): no
    block waits on one that has not started, so every run ends, and each
    gives bitwise what the blocks give one after another."""
    t = _bf16_case((2, 200, 2, 8, 16, 64, True))
    ordered, _ = _run_blocks(t)
    shuffled, most = _run_blocks(t, order_seed=seed, resident=3)
    assert most >= 2
    assert all(torch.equal(a, b) for a, b in zip(ordered, shuffled))


def test_the_backward_variant_rule_is_the_forwards():
    """``takes_wgmma_bwd`` (the backward launcher's rule written out) is
    the forward's ``takes_wgmma`` at every dtype, width and chunk."""
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for N in (8, 16, 32, 64, 96, 128):
            for P in (16, 32, 64, 128):
                for chunk in (1, 32, 63, 64, 65, 256):
                    assert (ssd.takes_wgmma_bwd(dtype, N, P, chunk)
                            == ssd.takes_wgmma(dtype, N, P, chunk)), \
                        (dtype, N, P, chunk)
    assert ssd.takes_wgmma_bwd(torch.bfloat16, 128, 64, 256)   # mamba2
    assert not ssd.takes_wgmma_bwd(torch.bfloat16, 16, 64, 256)  # jamba
