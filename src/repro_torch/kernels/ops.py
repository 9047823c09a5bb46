"""Dispatch by device: the CUDA kernel for CUDA tensors, the plain PyTorch
version for CPU tensors.

The decision is the first tensor's device (the query, or the SSD scan's
``x``) and nothing else: there is no mode switch and no fallback. A CUDA
tensor goes to the kernel wrapper, which launches or raises. Unlike
``repro/kernels/ops.py``, the plain branch of :func:`paged_attention`
passes ``k_new``/``v_new`` through.
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
               "flash_attention": 0, "ssd_chunk": 0}


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


def flash_attention(q, k, v, causal: bool = True):
    if _on_cpu(q, "flash_attention"):
        return _ref.blockwise_attention(q, k, v, causal)
    return _fa.flash_attention(q, k, v, causal)


def ssd_chunk(x, dt, A, Bm, Cm, chunk: int):
    """-> (y in x's dtype, final state f32). The plain version keeps the
    reference's chunk rule (largest divisor of S <= ``chunk``); the kernel
    takes fixed chunks of at most 64 with a ragged last one, the same
    function up to rounding."""
    if _on_cpu(x, "ssd_chunk"):
        return _ref.ssd_chunk_scan(x, dt, A, Bm, Cm, chunk)
    return _ssd.ssd_chunk(x, dt, A, Bm, Cm, chunk)


def counts() -> dict:
    """Launches by kernel and by variant, and plain-version calls, since the
    last :func:`reset_counts`, as plain dicts."""
    return {"launches": {"paged_attention": _pa.launches,
                         "chunk_prefill_attention": _cp.launches,
                         "flash_attention": _fa.launches,
                         "ssd_chunk": _ssd.launches},
            "launches_by_variant": {
                name: dict(mod.launches_by_variant)
                for name, mod in (("chunk_prefill_attention", _cp),
                                  ("flash_attention", _fa),
                                  ("ssd_chunk", _ssd))},
            "plain_calls": dict(plain_calls)}


def reset_counts() -> None:
    """Zero every launch and plain-call count."""
    _pa.launches = 0
    for mod in (_cp, _fa, _ssd):
        mod.launches = 0
        for v in mod.launches_by_variant:
            mod.launches_by_variant[v] = 0
    for k in plain_calls:
        plain_calls[k] = 0
