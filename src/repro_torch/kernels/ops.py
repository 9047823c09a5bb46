"""Dispatch by device: the CUDA kernel for CUDA tensors, the plain PyTorch
version for CPU tensors.

The decision is the first tensor's device (the query, or the SSD scan's
``x``) and nothing else: there is no mode switch and no fallback. A CUDA
tensor goes to the kernel wrapper, which launches or raises. Unlike
``repro/kernels/ops.py``, the plain branch of :func:`paged_attention`
passes ``k_new``/``v_new`` through.

Training: on CUDA tensors with grad enabled and an input that requires it,
:func:`flash_attention` runs :class:`FlashAttentionFn`, the forward that
also writes the row log-sum-exp and the hand-written backward; without grad
it is the serving forward unchanged. On CPU tensors autograd differentiates
the plain version. The SSD scan has no backward kernel yet, so
:func:`ssd_chunk` raises on CUDA tensors that require grad.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import chunk_prefill as _cp
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ssd_chunk as _ssd

# calls that took the plain version, by kernel name (a run on the card
# reads these to show its main path never did)
plain_calls = {"paged_attention": 0, "chunk_prefill_attention": 0,
               "flash_attention": 0, "flash_attention_bwd": 0,
               "ssd_chunk": 0}


def _on_cpu(t: torch.Tensor, name: str) -> bool:
    if t.device.type == "cpu":
        plain_calls[name] += 1
        return True
    return False


def paged_attention(q, k_pages, v_pages, block_table, seq_lens,
                    k_new=None, v_new=None):
    if _on_cpu(q, "paged_attention"):
        return _ref.paged_attention_ref(q, k_pages, v_pages, block_table,
                                        seq_lens, k_new=k_new, v_new=v_new)
    return _pa.paged_attention(q, k_pages, v_pages, block_table, seq_lens,
                               k_new=k_new, v_new=v_new)


def chunk_prefill_attention(q, k_pages, v_pages, block_table, positions):
    if _on_cpu(q, "chunk_prefill_attention"):
        return _ref.chunk_prefill_attention_ref(q, k_pages, v_pages,
                                                block_table, positions)
    return _cp.chunk_prefill_attention(q, k_pages, v_pages, block_table,
                                       positions)


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with its hand-written backward: the forward kernel
    writes the row log-sum-exp beside the output, and the backward kernel
    recomputes the probabilities from it (nothing of size Sq x Sk is
    saved)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        o, lse = _fa.flash_attention_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _fa.flash_attention_bwd(q, k, v, o, lse,
                                             dout.contiguous(), ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = True):
    if _on_cpu(q, "flash_attention"):
        if _needs_grad(q, k, v):
            plain_calls["flash_attention_bwd"] += 1
        return _ref.blockwise_attention(q, k, v, causal)
    if _needs_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, causal)
    return _fa.flash_attention(q, k, v, causal)


def ssd_chunk(x, dt, A, Bm, Cm, chunk: int):
    """-> (y in x's dtype, final state f32). The plain version keeps the
    reference's chunk rule (largest divisor of S <= ``chunk``); the kernel
    takes fixed chunks of at most 64 with a ragged last one, the same
    function up to rounding."""
    if _on_cpu(x, "ssd_chunk"):
        return _ref.ssd_chunk_scan(x, dt, A, Bm, Cm, chunk)
    if _needs_grad(x, dt, A, Bm, Cm):
        raise NotImplementedError(
            "ssd_chunk: the SSD scan's backward kernel is not ported yet "
            "(ROADMAP), so a Mamba2 layer does not train on the card")
    return _ssd.ssd_chunk(x, dt, A, Bm, Cm, chunk)


def counts() -> dict:
    """Launches by kernel and by variant, and plain-version calls, since the
    last :func:`reset_counts`, as plain dicts."""
    return {"launches": {"paged_attention": _pa.launches,
                         "chunk_prefill_attention": _cp.launches,
                         "flash_attention": _fa.launches,
                         "flash_attention_lse": _fa.lse_launches,
                         "flash_attention_bwd": _fa.bwd_launches,
                         "ssd_chunk": _ssd.launches},
            "launches_by_variant": {
                "chunk_prefill_attention": dict(_cp.launches_by_variant),
                "flash_attention": dict(_fa.launches_by_variant),
                "flash_attention_lse": dict(_fa.lse_launches_by_variant),
                "flash_attention_bwd": dict(_fa.bwd_launches_by_variant),
                "ssd_chunk": dict(_ssd.launches_by_variant)},
            "plain_calls": dict(plain_calls)}


def reset_counts() -> None:
    """Zero every launch and plain-call count."""
    _pa.launches = _fa.lse_launches = _fa.bwd_launches = 0
    for mod in (_cp, _fa, _ssd):
        mod.launches = 0
    for by in (_cp.launches_by_variant, _fa.launches_by_variant,
               _fa.lse_launches_by_variant, _fa.bwd_launches_by_variant,
               _ssd.launches_by_variant):
        for v in by:
            by[v] = 0
    for k in plain_calls:
        plain_calls[k] = 0
