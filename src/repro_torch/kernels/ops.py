"""Dispatch by device: the CUDA kernel for CUDA tensors, the plain PyTorch
version for CPU tensors.

The decision is the first tensor's device (the query, or the SSD scan's
``x``) and nothing else: there is no mode switch and no fallback. A CUDA
tensor goes to the kernel wrapper, which launches or raises. Unlike
``repro/kernels/ops.py``, the plain branch of :func:`paged_attention`
passes ``k_new``/``v_new`` through.

Training: on CUDA tensors with grad enabled and an input that requires it,
:func:`flash_attention` runs :class:`FlashAttentionFn`, the forward that
also writes the row log-sum-exp and the hand-written backward, and
:func:`ssd_chunk` runs :class:`SSDChunkFn`, the serving forward and the
hand-written SSD backward; without grad each is the serving forward
unchanged. On CPU tensors autograd differentiates the plain versions,
counted under ``flash_attention_bwd`` and ``ssd_chunk_bwd`` when the
backward runs, once per backward pass through the call.

On ``meta`` tensors (the dry run, :mod:`repro_torch.launch.counter`) each
kernel allocates what its CUDA wrapper allocates (outputs and scratch,
from the wrapper's ``allocate``) on ``meta`` and passes its cost function
(:mod:`repro_torch.kernels.cost`) to :data:`charge`, the hook the active
counter installs: no kernel launches, no plain version runs and nothing
is counted in ``plain_calls``. On ``cpu`` and ``cuda``
dispatch is as above.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import chunk_prefill as _cp
from repro_torch.kernels import cost as _cost
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ssd_chunk as _ssd

# calls that took the plain version, by kernel name (a run on the card
# reads these to show its main path never did)
plain_calls = {"paged_attention": 0, "chunk_prefill_attention": 0,
               "flash_attention": 0, "flash_attention_bwd": 0,
               "ssd_chunk": 0, "ssd_chunk_bwd": 0}


def _on_cpu(t: torch.Tensor, name: str) -> bool:
    if t.device.type == "cpu":
        plain_calls[name] += 1
        return True
    return False


def _on_meta(t: torch.Tensor) -> bool:
    return t.device.type == "meta"


# ------------------------------------------------------------------ meta
# The dry run's counter (repro_torch.launch.counter) installs its
# charge(name, n_bytes, n_flops) here while it is active.
charge = None


def _charge(name: str, cost) -> None:
    if charge is not None:
        charge(name, *cost)


# Each meta branch allocates, on meta, what its CUDA wrapper allocates
# (the wrapper's ``allocate``: outputs and scratch), and charges the
# kernel's cost function. A paged kernel's cost depends on the sequence
# lengths, which meta tensors do not hold: it is charged every lane at the
# table's whole length (W * page rows), as a decode cell's positions
# (seq_len - 1) make it.

def _paged_meta(q, k_pages, block_table, lse: bool):
    B, H, hd = q.shape
    _, page, Hkv, _ = k_pages.shape
    W = block_table.shape[1]
    out, _, row_lse = _pa.allocate(q, Hkv, W, page, lse)
    _charge("paged_attention", _cost.paged_cost(
        [W * page] * B, H, Hkv, hd, W, q.element_size(), lse))
    return (out, row_lse) if lse else out


def _chunk_meta(q, k_pages, block_table):
    B, C, H, hd = q.shape
    _, page, Hkv, _ = k_pages.shape
    W = block_table.shape[1]
    top = W * page
    pos = torch.arange(top - C, top, dtype=torch.int32).expand(B, C)
    _charge("chunk_prefill_attention",
            _cost.chunk_cost(pos, H, Hkv, hd, W, q.element_size()))
    return _cp.allocate(q)


def _flash_meta(q, k, causal: bool, lse: bool, q_offset: int = 0):
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    n_bytes, n_flops = _cost.flash_cost(Sq, Sk, H, Hkv, hd, causal,
                                        q.element_size(), q_offset)
    out, row_lse = _fa.allocate(q, lse)
    if not lse:
        _charge("flash_attention", (B * n_bytes, B * n_flops))
        return out
    _charge("flash_attention_lse", (B * n_bytes + B * H * Sq * 4,
                                    B * n_flops))
    return out, row_lse


def _flash_bwd_meta(q, k, v, lse, causal: bool, q_offset: int = 0):
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    dq, dk, dv, _ = _fa.allocate_bwd(q, k, v, lse)
    _charge("flash_attention_bwd", _cost.bwd_cost(
        B, Sq, Sk, H, Hkv, hd, causal, q.element_size(), q_offset))
    return dq, dk, dv


def _ssd_meta(x, Bm, chunk: int):
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    _charge("ssd_chunk", [B * n for n in _cost.ssd_cost(
        S, H, P, N, min(chunk, _ssd.MAX_CHUNK), x.element_size())])
    return _ssd.allocate(x, N)


def _ssd_bwd_meta(x, dt, A, Bm, Cm, dstate, chunk: int):
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, _ssd.MAX_CHUNK)
    grads, _ = _ssd.allocate_bwd(x, dt, A, Bm, Cm, Q,
                                 _ssd.takes_wgmma_bwd(x.dtype, N, P, Q))
    _charge("ssd_chunk_bwd", _cost.ssd_bwd_cost(
        B, S, H, P, N, Q, x.element_size(), dstate is not None))
    return grads


# ------------------------------------------------------------- dispatch
def paged_attention(q, k_pages, v_pages, block_table, seq_lens,
                    k_new=None, v_new=None, return_lse: bool = False):
    """-> out, or (out, the row log-sum-exp) with ``return_lse``
    (:func:`repro_torch.kernels.paged_attention.paged_attention`)."""
    if _on_meta(q):
        return _paged_meta(q, k_pages, block_table, return_lse)
    if _on_cpu(q, "paged_attention"):
        return _ref.paged_attention_ref(q, k_pages, v_pages, block_table,
                                        seq_lens, k_new=k_new, v_new=v_new,
                                        return_lse=return_lse)
    return _pa.paged_attention(q, k_pages, v_pages, block_table, seq_lens,
                               k_new=k_new, v_new=v_new,
                               return_lse=return_lse)


def chunk_prefill_attention(q, k_pages, v_pages, block_table, positions):
    if _on_meta(q):
        return _chunk_meta(q, k_pages, block_table)
    if _on_cpu(q, "chunk_prefill_attention"):
        return _ref.chunk_prefill_attention_ref(q, k_pages, v_pages,
                                                block_table, positions)
    return _cp.chunk_prefill_attention(q, k_pages, v_pages, block_table,
                                       positions)


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


class _CountPlainBackward(torch.autograd.Function):
    """The identity on a plain version's outputs whose backward counts one
    plain backward under ``name`` and passes the gradients through."""

    @staticmethod
    def forward(ctx, name: str, *outs):
        ctx.name = name
        ctx.set_materialize_grads(False)
        return outs[0] if len(outs) == 1 else outs

    @staticmethod
    def backward(ctx, *grads):
        plain_calls[ctx.name] += 1
        return (None, *grads)


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with its hand-written backward: the forward kernel
    writes the row log-sum-exp beside the output, and the backward kernel
    recomputes the probabilities from it (nothing of size Sq x Sk is
    saved)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_offset: int):
        if _on_meta(q):
            o, lse = _flash_meta(q, k, causal, lse=True, q_offset=q_offset)
        else:
            o, lse = _fa.flash_attention_fwd(q, k, v, causal, q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.q_offset = causal, q_offset
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        if _on_meta(q):
            return (*_flash_bwd_meta(q, k, v, lse, ctx.causal, ctx.q_offset),
                    None, None)
        dq, dk, dv = _fa.flash_attention_bwd(q, k, v, o, lse,
                                             dout.contiguous(), ctx.causal,
                                             ctx.q_offset)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True, q_offset: int = 0):
    """-> [B, Sq, H, hd]; causal with query i seeing keys j <= i +
    ``q_offset`` (:func:`repro_torch.kernels.flash_attention.
    flash_attention`), under grad too: the backward kernel applies the same
    mask."""
    if _on_meta(q) and not _needs_grad(q, k, v):
        return _flash_meta(q, k, causal, lse=False, q_offset=q_offset)
    if _on_cpu(q, "flash_attention"):
        out = _ref.blockwise_attention(q, k, v, causal, q_offset)
        if out.requires_grad:
            out = _CountPlainBackward.apply("flash_attention_bwd", out)
        return out
    if _needs_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, causal, q_offset)
    return _fa.flash_attention(q, k, v, causal, q_offset)


class SSDChunkFn(torch.autograd.Function):
    """The SSD scan with its hand-written backward: the serving forward
    kernel, and the backward kernel, which recomputes the chunk states
    from the saved inputs (nothing else is saved). A final state whose
    gradient is None counts as a zero one."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk: int):
        ctx.set_materialize_grads(False)
        if _on_meta(x):
            y, state = _ssd_meta(x, Bm, chunk)
        else:
            _ssd.check_bwd(x.dtype, Bm.shape[-1], x.shape[-1], chunk)
            y, state = _ssd.ssd_chunk(x, dt, A, Bm, Cm, chunk)
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk = chunk
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, Bm, Cm = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        if dstate is not None:
            dstate = dstate.contiguous()
        if _on_meta(x):
            return (*_ssd_bwd_meta(x, dt, A, Bm, Cm, dstate, ctx.chunk),
                    None)
        return (*_ssd.ssd_chunk_bwd(x, dt, A, Bm, Cm, dy, dstate,
                                    ctx.chunk), None)


def ssd_chunk(x, dt, A, Bm, Cm, chunk: int):
    """-> (y in x's dtype, final state f32). The plain version keeps the
    reference's chunk rule (largest divisor of S <= ``chunk``); the kernel
    takes fixed chunks of at most 64 with a ragged last one, the same
    function up to rounding."""
    if _on_meta(x) and not _needs_grad(x, dt, A, Bm, Cm):
        return _ssd_meta(x, Bm, chunk)
    if _on_cpu(x, "ssd_chunk"):
        y, state = _ref.ssd_chunk_scan(x, dt, A, Bm, Cm, chunk)
        if y.requires_grad:
            y, state = _CountPlainBackward.apply("ssd_chunk_bwd", y, state)
        return y, state
    if _needs_grad(x, dt, A, Bm, Cm):
        return SSDChunkFn.apply(x, dt, A, Bm, Cm, chunk)
    return _ssd.ssd_chunk(x, dt, A, Bm, Cm, chunk)


def counts() -> dict:
    """Launches by kernel, by variant and (flash's three wrappers) with a
    nonzero ``q_offset``, and plain-version calls, since the last
    :func:`reset_counts`, as plain dicts."""
    return {"launches": {"paged_attention": _pa.launches,
                         "chunk_prefill_attention": _cp.launches,
                         "flash_attention": _fa.launches,
                         "flash_attention_lse": _fa.lse_launches,
                         "flash_attention_bwd": _fa.bwd_launches,
                         "ssd_chunk": _ssd.launches,
                         "ssd_chunk_bwd": _ssd.bwd_launches},
            "launches_by_variant": {
                "chunk_prefill_attention": dict(_cp.launches_by_variant),
                "flash_attention": dict(_fa.launches_by_variant),
                "flash_attention_lse": dict(_fa.lse_launches_by_variant),
                "flash_attention_bwd": dict(_fa.bwd_launches_by_variant),
                "ssd_chunk": dict(_ssd.launches_by_variant),
                "ssd_chunk_bwd": dict(_ssd.bwd_launches_by_variant)},
            "launches_with_offset": dict(_fa.offset_launches),
            "plain_calls": dict(plain_calls)}


def reset_counts() -> None:
    """Zero every launch and plain-call count."""
    _pa.launches = _fa.lse_launches = _fa.bwd_launches = 0
    _ssd.bwd_launches = 0
    for mod in (_cp, _fa, _ssd):
        mod.launches = 0
    for by in (_cp.launches_by_variant, _fa.launches_by_variant,
               _fa.lse_launches_by_variant, _fa.bwd_launches_by_variant,
               _fa.offset_launches, _ssd.launches_by_variant,
               _ssd.bwd_launches_by_variant):
        for v in by:
            by[v] = 0
    for k in plain_calls:
        plain_calls[k] = 0
