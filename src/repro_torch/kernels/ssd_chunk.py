"""Mamba2 SSD chunked scan on the H100: the wrapper of ``csrc/ssd_chunk.cu``.

Replaces the Pallas kernel ``repro/kernels/ssd_chunk.py``. The plain PyTorch
version is :func:`repro_torch.kernels.ref.ssd_chunk_scan`; the dispatch
between the two by device is :mod:`repro_torch.kernels.ops`.

The C launcher picks one of two variants from (dtype, N, P, chunk) alone:
``wgmma`` (bf16, N and P of 64 or 128, chunks of 64: tensor cores, TMA) or
``simt`` (f32, other widths and shorter chunks: the CUDA-core loop).
:data:`launches_by_variant` counts each; :func:`takes_wgmma` is the rule
written out in Python.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build

_NAME = "ssd_chunk"
MAX_CHUNK = 64       # the kernel's largest chunk (csrc/ssd_chunk.cu kMaxChunk)
MAX_STATE_DIM = 128  # N and P: the state and a chunk's tiles in shared memory
VARIANTS = ("simt", "wgmma")   # indexed by repro_ssd_chunk_variant
launches = 0   # kernel launches since the caller last reset it
launches_by_variant = {v: 0 for v in VARIANTS}


@functools.cache
def _fn():
    P, I = ctypes.c_void_p, ctypes.c_int
    f = _build.library("ssd_chunk").repro_ssd_chunk
    f.argtypes = [I, P, P, P, P, P, P, P, I, I, I, I, I, I, P]
    f.restype = I
    return f


def takes_wgmma(dtype: torch.dtype, N: int, P: int, chunk: int) -> bool:
    """The launcher's rule (``repro_ssd_chunk_variant``) in Python."""
    return (dtype == torch.bfloat16 and N in (64, 128) and P in (64, 128)
            and min(chunk, MAX_CHUNK) == MAX_CHUNK)


@functools.cache
def variant(dtype: torch.dtype, N: int, P: int, chunk: int) -> str:
    """The variant the launcher takes for (dtype, N, P, chunk), as the C
    library decides it."""
    f = _build.library("ssd_chunk").repro_ssd_chunk_variant
    f.argtypes = [ctypes.c_int] * 4
    f.restype = ctypes.c_int
    return VARIANTS[f(_build.DTYPE_CODES[dtype], N, P,
                      min(chunk, MAX_CHUNK))]


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              Bm: torch.Tensor, Cm: torch.Tensor, chunk: int = MAX_CHUNK
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, H, P]; dt [B, S, H] f32 (post-softplus); A [H] f32
    (negative); Bm/Cm [B, S, H, N] (head-broadcast) in x's dtype.
    -> (y [B, S, H, P] in x's dtype, final state [B, H, N, P] f32).

    The kernel walks each sequence in chunks of ``min(chunk, 64)`` tokens,
    the last one ragged. Launches on the current stream; raises on any
    input it does not take and on a failed launch."""
    global launches
    _build.require(x.dim() == 4, _NAME,
                   f"x must be [B, S, H, P], got {tuple(x.shape)}")
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    _build.require(dt.shape == (B, S, H) and A.shape == (H,)
                   and Bm.shape == (B, S, H, N) and Cm.shape == Bm.shape,
                   _NAME, f"dt must be [B, S, H], A [H] and B/C [B, S, H, N]"
                   f" for x {tuple(x.shape)}, got {tuple(dt.shape)} / "
                   f"{tuple(A.shape)} / {tuple(Bm.shape)} / "
                   f"{tuple(Cm.shape)}")
    _build.require(0 < N <= MAX_STATE_DIM and 0 < P <= MAX_STATE_DIM, _NAME,
                   f"N and P must be in 1..{MAX_STATE_DIM}, got {N}, {P}")
    _build.require(chunk >= 1, _NAME, f"chunk must be >= 1, got {chunk}")
    _build.check_tensors(_NAME, [x, Bm, Cm], [])
    _build.check_tensors(_NAME, [dt, A], [])
    _build.require(dt.dtype == torch.float32 and dt.device == x.device,
                   _NAME, "dt and A must be float32 on x's device")
    y = torch.empty_like(x)
    state = torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
    which = variant(x.dtype, N, P, chunk)
    if which == "wgmma":
        _build.check_aligned(_NAME, [x, Bm, Cm, y])
    if B == 0 or S == 0 or H == 0:
        return y, state
    err = _fn()(_build.DTYPE_CODES[x.dtype], x.data_ptr(), dt.data_ptr(),
                A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
                state.data_ptr(), B, S, H, P, N, min(chunk, MAX_CHUNK),
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, _NAME)
    launches += 1
    launches_by_variant[which] += 1
    return y, state
