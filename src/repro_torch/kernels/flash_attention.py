"""Dense softmax attention on the H100: the wrappers of
``csrc/flash_attention.cu`` (the forward) and ``csrc/flash_attention_bwd.cu``
(its backward).

The forward replaces the Pallas kernel ``repro/kernels/flash_attention.py``.
The plain PyTorch versions are
:func:`repro_torch.kernels.ref.blockwise_attention` (serving),
:func:`~repro_torch.kernels.ref.flash_attention_lse` and
:func:`~repro_torch.kernels.ref.flash_attention_bwd_ref` (training); the
dispatch by device, and the autograd function that pairs the training
forward with the backward, are in :mod:`repro_torch.kernels.ops`. The
backward has no Pallas counterpart: the reference differentiates its jnp
attention with JAX autodiff.

The forward's launcher picks one of two variants from (dtype, hd) alone:
``wgmma`` (bf16 with hd 64 or 128: tensor cores, TMA) or ``simt`` (f32 and
other widths: the CUDA-core tile loop); the backward's likewise, ``wgmma``
(bf16 with hd 64 or 128: two deterministic passes of ``wgmma`` fed by TMA)
or ``simt``.
Each wrapper counts its launches, in total, by variant and with a
nonzero ``q_offset`` (a context-parallel rank past the first): the serving
forward (:func:`flash_attention`), the forward that also writes the row
log-sum-exp (:func:`flash_attention_fwd`) and the backward
(:func:`flash_attention_bwd`).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_NAME = "flash_attention"
VARIANTS = ("simt", "wgmma")   # indexed by repro_flash_attention_variant
BWD_VARIANTS = ("simt", "wgmma")  # by repro_flash_attention_bwd_variant
# kernel launches since the caller last reset them: the serving forward, the
# forward with the row log-sum-exp, and the backward
launches = 0
launches_by_variant = {v: 0 for v in VARIANTS}
lse_launches = 0
lse_launches_by_variant = {v: 0 for v in VARIANTS}
bwd_launches = 0
bwd_launches_by_variant = {v: 0 for v in BWD_VARIANTS}
# of those launches, the ones with a nonzero q_offset, by wrapper
offset_launches = {"flash_attention": 0, "flash_attention_lse": 0,
                   "flash_attention_bwd": 0}


@functools.cache
def _fn():
    P, I = ctypes.c_void_p, ctypes.c_int
    f = _build.library("flash_attention").repro_flash_attention
    f.argtypes = [I, P, P, P, P, P, I, I, I, I, I, I, I, I, ctypes.c_float,
                  P]
    f.restype = I
    return f


@functools.cache
def _bwd_fn():
    P, I = ctypes.c_void_p, ctypes.c_int
    f = _build.library("flash_attention_bwd").repro_flash_attention_bwd
    f.argtypes = [I, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I,
                  ctypes.c_float, P]
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


@functools.cache
def bwd_variant(dtype: torch.dtype, hd: int) -> str:
    """The variant the backward's launcher takes for (dtype, hd)."""
    f = (_build.library("flash_attention_bwd")
         .repro_flash_attention_bwd_variant)
    f.argtypes = [ctypes.c_int, ctypes.c_int]
    f.restype = ctypes.c_int
    return BWD_VARIANTS[f(_build.DTYPE_CODES[dtype], hd)]


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           max_hd: int = _build.MAX_HEAD_DIM):
    """The checks every wrapper makes of q, k and v; -> (B, Sq, Sk, H, Hkv,
    hd)."""
    _build.require(q.dim() == 4 and k.dim() == 4 and v.shape == k.shape,
                   _NAME, f"q must be [B, Sq, H, hd] and k/v [B, Sk, Hkv, "
                   f"hd], got {tuple(q.shape)} / {tuple(k.shape)} / "
                   f"{tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    _, Sk, Hkv, hd_k = k.shape
    _build.require(k.shape[0] == B and hd_k == hd and Hkv > 0
                   and H % Hkv == 0 and hd <= max_hd, _NAME,
                   f"q {tuple(q.shape)} does not match k/v "
                   f"{tuple(k.shape)} (hd <= {max_hd})")
    _build.require(Sk > 0 or Sq == 0, _NAME, "no keys to attend to")
    _build.check_tensors(_NAME, [q, k, v], [])
    return B, Sq, Sk, H, Hkv, hd


def allocate(q: torch.Tensor, with_lse: bool):
    """The forward's outputs on q's device: -> (out like q, the row
    log-sum-exp [B, H, Sq] f32 when ``with_lse``, else None)."""
    B, Sq, H, _ = q.shape
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    return torch.empty_like(q), lse


def allocate_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lse: torch.Tensor):
    """The backward's outputs and scratch on q's device: -> (dq, dk, dv
    like q, k, v; delta like lse, each row's dout . o in f32)."""
    return (*(torch.empty_like(t) for t in (q, k, v)),
            torch.empty_like(lse))


def _forward(q, k, v, causal: bool, out, lse, dims,
             q_offset: int = 0) -> torch.Tensor:
    B, Sq, Sk, H, Hkv, hd = dims
    _build.check_aligned(_NAME, [q, k, v, out])
    if B == 0 or Sq == 0:
        return out
    err = _fn()(_build.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), B, Sq, Sk, H, Hkv,
                hd, int(causal), q_offset, hd ** -0.5,
                torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, _NAME)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q [B, Sq, H, hd]; k/v [B, Sk, Hkv, hd] with Hkv dividing H (query
    head h reads kv head h // (H / Hkv)); ``causal`` masks key j from query
    i when j > i + ``q_offset`` (top-left aligned at 0; a context-parallel
    rank's queries are rows ``q_offset ..`` of the keys' sequence).
    -> [B, Sq, H, hd] in q's dtype.

    Launches the CUDA kernel on the current stream; raises on any input it
    does not take and on a failed launch."""
    global launches
    dims = _check(q, k, v)
    _build.require(q_offset >= 0, _NAME, f"q_offset {q_offset} < 0")
    out = _forward(q, k, v, causal, allocate(q, False)[0], None, dims,
                   q_offset)
    launches += 1
    launches_by_variant[variant(q.dtype, q.shape[3])] += 1
    offset_launches["flash_attention"] += q_offset > 0
    return out


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, q_offset: int = 0):
    """:func:`flash_attention` that also writes each row's log-sum-exp:
    -> (out [B, Sq, H, hd] in q's dtype, lse [B, H, Sq] f32, the natural
    log of the softmax denominator over the scaled scores). The same
    kernel and variant as the serving forward; ``out`` has the same bits."""
    global lse_launches
    dims = _check(q, k, v, _build.MAX_BWD_HEAD_DIM)
    _build.require(q_offset >= 0, _NAME, f"q_offset {q_offset} < 0")
    out, lse = allocate(q, True)
    _build.check_aligned(_NAME, [lse])
    out = _forward(q, k, v, causal, out, lse, dims, q_offset)
    lse_launches += 1
    lse_launches_by_variant[variant(q.dtype, q.shape[3])] += 1
    offset_launches["flash_attention_lse"] += q_offset > 0
    return out, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, causal: bool = True,
                        q_offset: int = 0):
    """The gradients of :func:`flash_attention_fwd`'s output: q, k, v,
    ``causal`` and ``q_offset`` as there, ``o`` and ``lse`` what it
    returned, ``dout`` the gradient of ``o``. -> (dq, dk, dv) in q's dtype
    and shapes. Deterministic: no atomics, so equal inputs give equal
    bits.

    Launches the CUDA kernels on the current stream; raises on any input
    they do not take and on a failed launch."""
    global bwd_launches
    B, Sq, Sk, H, Hkv, hd = _check(q, k, v, _build.MAX_BWD_HEAD_DIM)
    _build.require(o.shape == q.shape and dout.shape == q.shape
                   and lse.shape == (B, H, Sq)
                   and lse.dtype == torch.float32, _NAME,
                   f"o and dout must be {tuple(q.shape)} and lse "
                   f"[{B}, {H}, {Sq}] float32")
    _build.require(q_offset >= 0, _NAME, f"q_offset {q_offset} < 0")
    _build.check_tensors(_NAME, [q, k, v, o, dout], [])
    _build.check_tensors(_NAME, [lse], [])
    dq, dk, dv, delta = allocate_bwd(q, k, v, lse)
    _build.check_aligned(_NAME, [q, k, v, o, dout, lse, delta, dq, dk, dv])
    if B == 0 or Sq == 0:
        return dq, dk.zero_(), dv.zero_()
    err = _bwd_fn()(_build.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), o.data_ptr(), dout.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                    dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, H, Hkv, hd,
                    int(causal), q_offset, hd ** -0.5,
                    torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, f"{_NAME}_bwd")
    bwd_launches += 1
    bwd_launches_by_variant[bwd_variant(q.dtype, hd)] += 1
    offset_launches["flash_attention_bwd"] += q_offset > 0
    return dq, dk, dv
