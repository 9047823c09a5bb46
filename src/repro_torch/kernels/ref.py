"""Plain PyTorch versions of the kernels, and the oracles.

The paged-attention versions mirror the reference oracles in
``repro/kernels/ref.py`` operation by operation, dtype order included.
:func:`blockwise_attention` and :func:`ssd_chunk_scan` mirror what the
reference models compute where the dense flash and SSD kernels stand
(``repro/models/layers.py::blockwise_attention`` behind ``attn_full``,
``repro/models/mamba2.py::_ssd_chunk_scan``); :func:`flash_attention_ref`
and :func:`ssd_chunk_ref` are twins of the reference oracles. The plain
versions are what the CPU runs (the dispatch in
:mod:`repro_torch.kernels.ops` picks them for CPU tensors) and what the
CUDA kernels are held against on the card. :func:`flash_attention_lse` and
:func:`flash_attention_bwd_ref` are the explicit formulas of the training
forward (with the row log-sum-exp) and of the flash backward; only the
tests and the smoke call them.
"""
from __future__ import annotations

import torch


def _gather(pages: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """[n_rows, page, Hkv, hd] pages through a [B, slots] block table ->
    one contiguous [B, slots*page, Hkv, hd] view per sequence."""
    B, slots = block_table.shape
    _, page, Hkv, hd = pages.shape
    return pages[block_table.long()].reshape(B, slots * page, Hkv, hd)


def paged_attention_ref(q, k_pages, v_pages, block_table, seq_lens,
                        k_new=None, v_new=None):
    """q [B,H,hd]; pages [n_rows, page, Hkv, hd]; block_table [B,slots].

    ``seq_lens`` is clamped to >= 1 (an idle slot points at the null row).
    ``k_new``/``v_new`` [B,Hkv,hd] (optional) are spliced in at position
    ``seq_len - 1`` instead of being read from the pages: elementwise equal
    to scatter-then-gather, so the output is bitwise equal too.
    """
    B, H, hd = q.shape
    _, page, Hkv, _ = k_pages.shape
    slots = block_table.shape[1]
    seq_lens = torch.clamp(seq_lens.long(), min=1)
    k = _gather(k_pages, block_table)
    v = _gather(v_pages, block_table)
    if k_new is not None:
        pos = torch.arange(slots * page, device=q.device)
        w = (pos[None, :] == (seq_lens - 1)[:, None])[..., None, None]
        k = torch.where(w, k_new[:, None].to(k.dtype), k)
        v = torch.where(w, v_new[:, None].to(v.dtype), v)
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    s = torch.einsum("bhd,bkhd->bhk", q.float(), k.float()) * (hd ** -0.5)
    valid = torch.arange(slots * page, device=q.device)[None, :] \
        < seq_lens[:, None]
    s = s.masked_fill(~valid[:, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bkhd->bhd", p, v.float()).to(q.dtype)


def chunk_prefill_attention_ref(q, k_pages, v_pages, block_table, positions):
    """Chunked-prefill attention: a chunk of C query tokens per sequence
    attends to everything already written to its pages (earlier chunks and
    this chunk, which the caller scatters first) under a causal mask on
    absolute positions. q [B,C,H,hd]; positions [B,C] -> [B,C,H,hd].

    As in the reference oracle the score dot runs in the I/O dtype and is
    cast to f32 afterwards; the kernels upcast first, so the two are
    compared at f32.
    """
    B, C, H, hd = q.shape
    _, page, Hkv, _ = k_pages.shape
    slots = block_table.shape[1]
    k = _gather(k_pages, block_table)
    v = _gather(v_pages, block_table)
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * (hd ** -0.5)
    kpos = torch.arange(slots * page, device=q.device)
    mask = positions.long()[:, :, None] >= kpos[None, None, :]
    s = s.masked_fill(~mask[:, None], float("-inf"))
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=-1e30)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bkhd->bqhd", (p / l).to(v.dtype), v)


def _repeat_kv(k: torch.Tensor, v: torch.Tensor, H: int):
    """[B, S, Hkv, hd] K/V -> H heads (query head h reads kv head
    h // (H / Hkv))."""
    Hkv = k.shape[2]
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    return k, v


def flash_attention_ref(q, k, v, causal: bool = True):
    """The attention oracle. q [B,Sq,H,hd]; k/v [B,Sk,Hkv,hd]; causal is
    top-left aligned (query i sees keys j <= i). All in f32."""
    B, Sq, H, hd = q.shape
    k, v = _repeat_kv(k, v, H)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (hd ** -0.5)
    if causal:
        Sk = k.shape[1]
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        s = s.masked_fill(~mask[None, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


_Q_CHUNK = 512


def blockwise_attention(q, k, v, causal: bool = True):
    """Chunked softmax attention, the plain version of the flash kernel.
    q [B,Sq,H,hd]; k/v [B,Sk,Hkv,hd] (repeated to H heads here). Scores are
    materialised one q-chunk at a time (f32); the score dot runs in the I/O
    dtype, as in the reference's prefill."""
    B, S, H, hd = q.shape
    k, v = _repeat_kv(k, v, H)
    Sk = k.shape[1]
    scale = hd ** -0.5
    qc = min(_Q_CHUNK, S)
    while S % qc:
        qc -= 1                         # largest divisor <= _Q_CHUNK
    kpos = torch.arange(Sk, device=q.device)
    outs = []
    for idx in range(S // qc):
        qb = q[:, idx * qc:(idx + 1) * qc]
        scores = torch.einsum("bqhd,bkhd->bhqk", qb, k).float() * scale
        if causal:
            qpos = idx * qc + torch.arange(qc, device=q.device)
            mask = qpos[:, None] >= kpos[None, :]
            scores = scores.masked_fill(~mask[None, None], float("-inf"))
        m = torch.clamp(scores.amax(dim=-1, keepdim=True), min=-1e30)
        p_ = torch.exp(scores - m)
        l = p_.sum(dim=-1, keepdim=True)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", (p_ / l).to(v.dtype), v))
    return torch.cat(outs, dim=1)


def _scores(qc, k, i0: int, causal: bool):
    """f32 scaled scores [B,H,qc,Sk] of query rows i0.. (``qc`` [B,qc,H,hd])
    against ``k`` [B,Sk,H,hd], and the visibility mask (None when every key
    is visible)."""
    hd = qc.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", qc.float(), k.float()) * (hd ** -0.5)
    if not causal:
        return s, None
    qpos = i0 + torch.arange(qc.shape[1], device=qc.device)
    kpos = torch.arange(k.shape[1], device=qc.device)
    return s, (qpos[:, None] >= kpos[None, :])[None, None]


def flash_attention_lse(q, k, v, causal: bool = True):
    """The training forward's plain version: attention as
    :func:`flash_attention_ref` (all in f32, output in q's dtype) and each
    row's log-sum-exp over the scaled scores, lse [B,H,Sq] f32. q
    [B,Sq,H,hd]; k/v [B,Sk,Hkv,hd]. Scores one chunk of 512 query rows at a
    time."""
    B, Sq, H, hd = q.shape
    k, v = _repeat_kv(k, v, H)
    outs, lses = [], []
    for i0 in range(0, Sq, _Q_CHUNK):
        s, mask = _scores(q[:, i0:i0 + _Q_CHUNK], k, i0, causal)
        if mask is not None:
            s = s.masked_fill(~mask, float("-inf"))
        lse = torch.logsumexp(s, dim=-1)                   # [B,H,qc]
        p = torch.exp(s - lse[..., None])
        outs.append(torch.einsum("bhqk,bkhd->bqhd", p, v.float()))
        lses.append(lse)
    return torch.cat(outs, dim=1).to(q.dtype), torch.cat(lses, dim=2)


def flash_attention_bwd_ref(q, k, v, o, lse, dout, causal: bool = True):
    """The backward's plain version, from the forward's output ``o`` and
    row log-sum-exp ``lse`` [B,H,Sq] (f32): with P = exp(S * scale - lse)
    under the mask and D = rowsum(dout * o),

        dV = P^T dout,  dS = P * (dout V^T - D),
        dQ = dS K * scale,  dK = dS^T Q * scale,

    each kv head's dK and dV summed over the H / Hkv query heads that read
    it. All in f32; -> (dq, dk, dv) in q's dtype. One chunk of 512 query
    rows at a time."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    scale = hd ** -0.5
    kr, vr = (t.float() for t in _repeat_kv(k, v, H))
    delta = (dout.float() * o.float()).sum(-1).transpose(1, 2)  # [B,H,Sq]
    dq = torch.zeros((B, Sq, H, hd), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, Sk, H, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for i0 in range(0, Sq, _Q_CHUNK):
        i1 = min(i0 + _Q_CHUNK, Sq)
        qc, gc = q[:, i0:i1].float(), dout[:, i0:i1].float()
        s, mask = _scores(qc, kr, i0, causal)
        p = torch.exp(s - lse[:, :, i0:i1, None])
        if mask is not None:
            p = p.masked_fill(~mask, 0.0)
        dv += torch.einsum("bhqk,bqhd->bkhd", p, gc)
        dp = torch.einsum("bqhd,bkhd->bhqk", gc, vr)
        ds = p * (dp - delta[:, :, i0:i1, None])
        dq[:, i0:i1] = torch.einsum("bhqk,bkhd->bqhd", ds, kr) * scale
        dk += torch.einsum("bhqk,bqhd->bkhd", ds, qc) * scale
    g = H // Hkv
    dk = dk.reshape(B, Sk, Hkv, g, hd).sum(3)
    dv = dv.reshape(B, Sk, Hkv, g, hd).sum(3)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def ssd_chunk_ref(x, dt, A, Bm, Cm):
    """The exact sequential SSD recurrence, the oracle:
    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t ;  y_t = C_t . h_t.
    x [B,S,H,P]; dt [B,S,H]; A [H]; Bm/Cm [B,S,H,N]. -> y in x's dtype."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    h = torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
    A = A.float()
    ys = []
    for t in range(S):
        xt, dtt = x[:, t].float(), dt[:, t].float()
        bt, ct = Bm[:, t].float(), Cm[:, t].float()
        dA = torch.exp(dtt * A[None, :])
        h = h * dA[..., None, None] + torch.einsum(
            "bhn,bhp->bhnp", bt, xt * dtt[..., None])
        ys.append(torch.einsum("bhn,bhnp->bhp", ct, h))
    return torch.stack(ys, dim=1).to(x.dtype)


def ssd_chunk_scan(x, dt, A, Bm, Cm, chunk: int):
    """Chunked SSD, the plain version of the SSD kernel: a mirror of
    ``repro/models/mamba2.py::_ssd_chunk_scan``, chunk length the largest
    divisor of S <= ``chunk``. x [B,S,H,P]; dt [B,S,H] (post-softplus);
    A [H] (negative); Bm/Cm [B,S,H,N] (head-broadcast).
    -> (y [B,S,H,P] in x's dtype, final state [B,H,N,P] f32)."""
    B, S, H, P_ = x.shape
    N = Bm.shape[-1]
    Q = max(min(chunk, S), 1)
    while S % Q:
        Q -= 1
    dt32 = dt.float()
    iq = torch.arange(Q, device=x.device)
    causal = (iq[:, None] >= iq[None, :])[None, :, :, None]
    state = torch.zeros((B, H, N, P_), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, S, Q):
        xc = x[:, c0:c0 + Q].float()                # [B,Q,H,P]
        dc = dt32[:, c0:c0 + Q]                     # [B,Q,H]
        bc = Bm[:, c0:c0 + Q].float()               # [B,Q,H,N]
        cc = Cm[:, c0:c0 + Q].float()
        dA_cs = torch.cumsum(dc * A, dim=1)         # inclusive
        xdt = xc * dc[..., None]
        scores = torch.einsum("bqhn,bkhn->bqkh", cc, bc)
        L = torch.exp(dA_cs[:, :, None, :] - dA_cs[:, None, :, :])
        L = torch.where(causal, L, torch.zeros((), device=x.device))
        y = torch.einsum("bqkh,bkhp->bqhp", scores * L, xdt)
        y = y + torch.einsum("bqhn,bhnp->bqhp",
                             cc * torch.exp(dA_cs)[..., None], state)
        decay_to_end = torch.exp(dA_cs[:, -1:, :] - dA_cs)
        state = (state * torch.exp(dA_cs[:, -1])[..., None, None]
                 + torch.einsum("bkhn,bkhp->bhnp",
                                bc * decay_to_end[..., None], xdt))
        ys.append(y)
    y = (torch.cat(ys, dim=1) if ys
         else torch.zeros_like(x, dtype=torch.float32))
    return y.to(x.dtype), state
