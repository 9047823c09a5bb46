"""Paged decode attention on the H100: the wrapper of ``csrc/paged_attention.cu``.

Replaces the Pallas kernel ``repro/kernels/paged_attention.py``. The plain
PyTorch version is :func:`repro_torch.kernels.ref.paged_attention_ref`; the
dispatch between the two by device is :mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build

_NAME = "paged_attention"
launches = 0   # kernel launches since the caller last reset it


@functools.cache
def _fn():
    P, I = ctypes.c_void_p, ctypes.c_int
    f = _build.library("paged_attention").repro_paged_attention
    f.argtypes = [I, P, P, P, P, P, P, P, P, I, I, I, I, I, I,
                  ctypes.c_float, P]
    f.restype = I
    return f


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_table: torch.Tensor,
                    seq_lens: torch.Tensor,
                    k_new: Optional[torch.Tensor] = None,
                    v_new: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B, H, hd]; {k,v}_pages [n_rows, page, Hkv, hd] (one layer of the
    arena plane, read in place); block_table [B, W] int32 of valid plane
    rows; seq_lens [B] int32, clamped to >= 1; k_new/v_new [B, Hkv, hd]
    (optional) spliced in at position seq_len - 1. -> [B, H, hd] in q's
    dtype.

    Launches the CUDA kernel on the current stream; raises on any input it
    does not take and on a failed launch."""
    global launches
    B, H, hd = q.shape
    _build.require(k_pages.dim() == 4 and v_pages.shape == k_pages.shape,
                   _NAME, f"pages must be [n_rows, page, Hkv, hd], got "
                   f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    _, page, Hkv, hd_k = k_pages.shape
    W = block_table.shape[1]
    _build.require(hd_k == hd and H % Hkv == 0
                   and hd <= _build.MAX_HEAD_DIM, _NAME,
                   f"q {tuple(q.shape)} does not match pages "
                   f"{tuple(k_pages.shape)} (hd <= {_build.MAX_HEAD_DIM})")
    _build.require(block_table.shape == (B, W) and seq_lens.shape == (B,),
                   _NAME, "block_table must be [B, W] and seq_lens [B]")
    _build.require((k_new is None) == (v_new is None), _NAME,
                   "k_new and v_new come together")
    floats = [q, k_pages, v_pages]
    if k_new is not None:
        _build.require(k_new.shape == (B, Hkv, hd)
                       and v_new.shape == (B, Hkv, hd), _NAME,
                       "k_new/v_new must be [B, Hkv, hd]")
        floats += [k_new, v_new]
    _build.check_tensors(_NAME, floats, [block_table, seq_lens])
    out = torch.empty_like(q)
    if B == 0:
        return out
    err = _fn()(_build.DTYPE_CODES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
                v_pages.data_ptr(), block_table.data_ptr(),
                seq_lens.data_ptr(),
                k_new.data_ptr() if k_new is not None else None,
                v_new.data_ptr() if v_new is not None else None,
                out.data_ptr(), B, H, Hkv, hd, page, W, hd ** -0.5,
                torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, _NAME)
    launches += 1
    return out
