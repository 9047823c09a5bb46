"""Dense softmax attention on the H100: the wrapper of ``csrc/flash_attention.cu``.

Replaces the Pallas kernel ``repro/kernels/flash_attention.py``. The plain
PyTorch version is :func:`repro_torch.kernels.ref.blockwise_attention`; the
dispatch between the two by device is :mod:`repro_torch.kernels.ops`.

The C launcher picks one of two variants from (dtype, hd) alone: ``wgmma``
(bf16 with hd 64 or 128: tensor cores, TMA) or ``simt`` (f32 and other
widths: the CUDA-core tile loop). :data:`launches_by_variant` counts each.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_NAME = "flash_attention"
VARIANTS = ("simt", "wgmma")   # indexed by repro_flash_attention_variant
launches = 0   # kernel launches since the caller last reset it
launches_by_variant = {v: 0 for v in VARIANTS}


@functools.cache
def _fn():
    P, I = ctypes.c_void_p, ctypes.c_int
    f = _build.library("flash_attention").repro_flash_attention
    f.argtypes = [I, P, P, P, P, I, I, I, I, I, I, I, ctypes.c_float, P]
    f.restype = I
    return f


@functools.cache
def variant(dtype: torch.dtype, hd: int) -> str:
    """The variant the launcher takes for (dtype, hd), as the C library
    decides it."""
    f = _build.library("flash_attention").repro_flash_attention_variant
    f.argtypes = [ctypes.c_int, ctypes.c_int]
    f.restype = ctypes.c_int
    return VARIANTS[f(_build.DTYPE_CODES[dtype], hd)]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q [B, Sq, H, hd]; k/v [B, Sk, Hkv, hd] with Hkv dividing H (query
    head h reads kv head h // (H / Hkv)); ``causal`` masks key j from query
    i when j > i (top-left aligned). -> [B, Sq, H, hd] in q's dtype.

    Launches the CUDA kernel on the current stream; raises on any input it
    does not take and on a failed launch."""
    global launches
    _build.require(q.dim() == 4 and k.dim() == 4 and v.shape == k.shape,
                   _NAME, f"q must be [B, Sq, H, hd] and k/v [B, Sk, Hkv, "
                   f"hd], got {tuple(q.shape)} / {tuple(k.shape)} / "
                   f"{tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    _, Sk, Hkv, hd_k = k.shape
    _build.require(k.shape[0] == B and hd_k == hd and Hkv > 0
                   and H % Hkv == 0 and hd <= _build.MAX_HEAD_DIM, _NAME,
                   f"q {tuple(q.shape)} does not match k/v "
                   f"{tuple(k.shape)} (hd <= {_build.MAX_HEAD_DIM})")
    _build.require(Sk > 0 or Sq == 0, _NAME, "no keys to attend to")
    _build.check_tensors(_NAME, [q, k, v], [])
    out = torch.empty_like(q)
    _build.check_aligned(_NAME, [q, k, v, out])
    if B == 0 or Sq == 0:
        return out
    err = _fn()(_build.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), B, Sq, Sk, H, Hkv, hd,
                int(causal), hd ** -0.5,
                torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, _NAME)
    launches += 1
    launches_by_variant[variant(q.dtype, hd)] += 1
    return out
