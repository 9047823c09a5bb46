"""Paged decode attention on the H100: the wrapper of ``csrc/paged_attention.cu``.

Replaces the Pallas kernel ``repro/kernels/paged_attention.py``. The plain
PyTorch version is :func:`repro_torch.kernels.ref.paged_attention_ref`; the
dispatch between the two by device is :mod:`repro_torch.kernels.ops`.

The kernel splits each sequence's positions over several blocks
(flash-decoding); :func:`split_plan` chooses the split from the shapes
alone, so no device value is read on the host.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

_NAME = "paged_attention"
SPLIT_TILE = 32        # positions per tile of the kernel (kSplitTile)
TARGET_BLOCKS = 1056   # eight blocks for each of the H100's 132 SMs
launches = 0   # kernel launches since the caller last reset it


@functools.cache
def split_plan(B: int, Hkv: int, W: int, page: int) -> Tuple[int, int]:
    """(n_split, span): each sequence's positions [0, W * page) split into
    ``n_split`` spans of ``span`` positions, a whole number of tiles each,
    so that B * Hkv * n_split blocks come near :data:`TARGET_BLOCKS`. Only
    the last span may reach past W * page."""
    n_tiles = max(-(-(W * page) // SPLIT_TILE), 1)
    want = -(-TARGET_BLOCKS // max(B * Hkv, 1))
    per = -(-n_tiles // min(want, n_tiles))        # tiles per span
    return -(-n_tiles // per), per * SPLIT_TILE


@functools.cache
def _fn():
    P, I = ctypes.c_void_p, ctypes.c_int
    f = _build.library("paged_attention").repro_paged_attention
    f.argtypes = [I, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I,
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

    Launches the CUDA kernels on the current stream; raises on any input
    they do not take and on a failed launch."""
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
    _build.require(hd * q.element_size() % 16 == 0, _NAME,
                   "a head's row must be a multiple of 16 bytes")
    out = torch.empty_like(q)
    _build.check_aligned(_NAME, floats + [out])
    if B == 0:
        return out
    n_split, span = split_plan(B, Hkv, W, page)
    # the splits' f32 partials in one buffer: acc [B, Hkv, n_split, g, hd],
    # then ml [B, Hkv, n_split, g, 2] (16-byte aligned: hd % 4 == 0)
    n_rows = B * Hkv * n_split * (H // Hkv)
    scratch = torch.empty(n_rows * (hd + 2), dtype=torch.float32,
                          device=q.device)
    acc = scratch.data_ptr()
    err = _fn()(_build.DTYPE_CODES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
                v_pages.data_ptr(), block_table.data_ptr(),
                seq_lens.data_ptr(),
                k_new.data_ptr() if k_new is not None else None,
                v_new.data_ptr() if v_new is not None else None,
                out.data_ptr(), acc, acc + 4 * n_rows * hd,
                B, H, Hkv, hd, page, W, n_split, span, hd ** -0.5,
                torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, _NAME)
    launches += 1
    return out
