"""Chunked-prefill attention on the H100: the wrapper of ``csrc/chunk_prefill.cu``.

Replaces the Pallas kernel ``repro/kernels/chunk_prefill.py``. The plain
PyTorch version is
:func:`repro_torch.kernels.ref.chunk_prefill_attention_ref`; the dispatch
between the two by device is :mod:`repro_torch.kernels.ops`.

The C launcher picks one of two variants from (dtype, hd, page) alone:
``wgmma`` (bf16, hd 64 or 128, pages of 8, 16, 32 or 64 tokens: flash's
tensor-core loop with one TMA box per page) or ``simt`` (f32 and other
widths: the CUDA-core tile loop). :data:`launches_by_variant` counts each;
:func:`takes_wgmma` is the rule written out in Python.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_NAME = "chunk_prefill_attention"
VARIANTS = ("simt", "wgmma")   # indexed by repro_chunk_prefill_variant
WGMMA_PAGES = (8, 16, 32, 64)  # whole 8-row swizzle atoms, <= one tile
launches = 0   # kernel launches since the caller last reset it
launches_by_variant = {v: 0 for v in VARIANTS}


@functools.cache
def _fn():
    P, I = ctypes.c_void_p, ctypes.c_int
    f = _build.library("chunk_prefill").repro_chunk_prefill_attention
    f.argtypes = [I, P, P, P, P, P, P, I, I, I, I, I, I, I, I,
                  ctypes.c_float, P]
    f.restype = I
    return f


def allocate(q: torch.Tensor) -> torch.Tensor:
    """The kernel's output on q's device (it takes no scratch)."""
    return torch.empty_like(q)


def takes_wgmma(dtype: torch.dtype, hd: int, page: int) -> bool:
    """The launcher's rule (``repro_chunk_prefill_variant``) in Python."""
    return dtype == torch.bfloat16 and hd in (64, 128) and page in WGMMA_PAGES


@functools.cache
def variant(dtype: torch.dtype, hd: int, page: int) -> str:
    """The variant the launcher takes for (dtype, hd, page), as the C
    library decides it."""
    f = _build.library("chunk_prefill").repro_chunk_prefill_variant
    f.argtypes = [ctypes.c_int] * 3
    f.restype = ctypes.c_int
    return VARIANTS[f(_build.DTYPE_CODES[dtype], hd, page)]


def chunk_prefill_attention(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, block_table: torch.Tensor,
                            positions: torch.Tensor) -> torch.Tensor:
    """q [B, C, H, hd]; {k,v}_pages [n_rows, page, Hkv, hd] (one layer of the
    arena plane, read in place, already holding this chunk's K/V);
    block_table [B, W] int32 of valid plane rows; positions [B, C] int32
    absolute positions. -> [B, C, H, hd] in q's dtype.

    Launches the CUDA kernel on the current stream; raises on any input it
    does not take and on a failed launch."""
    global launches
    B, C, H, hd = q.shape
    _build.require(k_pages.dim() == 4 and v_pages.shape == k_pages.shape,
                   _NAME, f"pages must be [n_rows, page, Hkv, hd], got "
                   f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    n_rows, page, Hkv, hd_k = k_pages.shape
    W = block_table.shape[1]
    _build.require(hd_k == hd and H % Hkv == 0
                   and hd <= _build.MAX_HEAD_DIM, _NAME,
                   f"q {tuple(q.shape)} does not match pages "
                   f"{tuple(k_pages.shape)} (hd <= {_build.MAX_HEAD_DIM})")
    _build.require(block_table.shape == (B, W)
                   and positions.shape == (B, C), _NAME,
                   "block_table must be [B, W] and positions [B, C]")
    _build.check_tensors(_NAME, [q, k_pages, v_pages],
                         [block_table, positions])
    out = allocate(q)
    which = variant(q.dtype, hd, page)
    if which == "wgmma":
        _build.check_aligned(_NAME, [q, k_pages, v_pages, out])
    if B == 0 or C == 0:
        return out
    err = _fn()(_build.DTYPE_CODES[q.dtype], q.data_ptr(),
                positions.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                block_table.data_ptr(), out.data_ptr(), B, C, H, Hkv, hd,
                page, W, n_rows, hd ** -0.5,
                torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, _NAME)
    launches += 1
    launches_by_variant[which] += 1
    return out
