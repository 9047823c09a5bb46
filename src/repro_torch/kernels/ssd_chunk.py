"""Mamba2 SSD chunked scan on the H100: the wrappers of ``csrc/ssd_chunk.cu``
and of its backward, ``csrc/ssd_chunk_bwd.cu``.

Replaces the Pallas kernel ``repro/kernels/ssd_chunk.py``. The plain PyTorch
version is :func:`repro_torch.kernels.ref.ssd_chunk_scan`; the dispatch
between the two by device is :mod:`repro_torch.kernels.ops`. The backward
(:func:`ssd_chunk_bwd`, whose plain version is
:func:`repro_torch.kernels.ref.ssd_chunk_bwd`) replaces no Pallas kernel:
the reference differentiates its jnp scan with JAX autodiff.

The C launchers pick one of two variants from (dtype, N, P, chunk) alone,
the backward by the forward's rule: ``wgmma`` (bf16, N and P of 64 or 128,
chunks of 64: tensor cores, TMA) or ``simt`` (f32, other widths and shorter
chunks: CUDA-core loops). :data:`launches_by_variant` and
:data:`bwd_launches_by_variant` count each; :func:`takes_wgmma` and
:func:`takes_wgmma_bwd` are the rules written out in Python.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

_NAME = "ssd_chunk"
MAX_CHUNK = 64       # the kernel's largest chunk (csrc/ssd_chunk.cu kMaxChunk)
MAX_STATE_DIM = 128  # N and P: the state and a chunk's tiles in shared memory
VARIANTS = ("simt", "wgmma")   # indexed by repro_ssd_chunk_variant
launches = 0   # kernel launches since the caller last reset it
launches_by_variant = {v: 0 for v in VARIANTS}
BWD_VARIANTS = ("simt", "wgmma")   # indexed by repro_ssd_chunk_bwd_variant
bwd_launches = 0
bwd_launches_by_variant = {v: 0 for v in BWD_VARIANTS}
MAX_SMEM = 232448              # a block's shared memory on the H100


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


def allocate(x: torch.Tensor, N: int):
    """The scan's outputs on x's device: -> (y like x, the final state
    [B, H, N, P] f32, zeroed)."""
    B, _, H, P = x.shape
    return torch.empty_like(x), torch.zeros((B, H, N, P),
                                            dtype=torch.float32,
                                            device=x.device)


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
    y, state = allocate(x, N)
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


@functools.cache
def _bwd_fn():
    P, I = ctypes.c_void_p, ctypes.c_int
    f = _build.library("ssd_chunk_bwd").repro_ssd_chunk_bwd
    f.argtypes = [I] + [P] * 17 + [I] * 6 + [P]
    f.restype = I
    return f


def takes_wgmma_bwd(dtype: torch.dtype, N: int, P: int, chunk: int) -> bool:
    """The backward launcher's rule (``repro_ssd_chunk_bwd_variant``) in
    Python: the forward's, so a scan and its gradient take one variant."""
    return (dtype == torch.bfloat16 and N in (64, 128) and P in (64, 128)
            and min(chunk, MAX_CHUNK) == MAX_CHUNK)


@functools.cache
def bwd_variant(dtype: torch.dtype, N: int, P: int, chunk: int) -> str:
    """The variant the backward's launcher takes for (dtype, N, P, chunk),
    as the C library decides it."""
    f = _build.library("ssd_chunk_bwd").repro_ssd_chunk_bwd_variant
    f.argtypes = [ctypes.c_int] * 4
    f.restype = ctypes.c_int
    return BWD_VARIANTS[f(_build.DTYPE_CODES[dtype], N, P,
                          min(chunk, MAX_CHUNK))]


@functools.cache
def bwd_smem(dtype: torch.dtype, N: int, P: int, chunk: int) -> int:
    """Shared memory (bytes) of the backward's largest block at (dtype, N,
    P, chunk), for the variant it takes, as the C library computes it."""
    f = _build.library("ssd_chunk_bwd").repro_ssd_chunk_bwd_smem
    f.argtypes = [ctypes.c_int] * 4
    f.restype = ctypes.c_longlong
    return int(f(_build.DTYPE_CODES[dtype], N, P, min(chunk, MAX_CHUNK)))


def allocate_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, Q: int, wgmma: bool):
    """The backward's outputs and scratch on x's device for chunks of
    ``Q``: -> ((dx, ddt, dA, dB, dC), (states, per_chunk, flags)). dA is
    zeroed. The f32 scratch: each chunk's state and its gradient, [2, B,
    n_chunks, H, N, P]; each chunk's decay and share of dA, [2, B,
    n_chunks, H]; the ``wgmma`` variant's tickets and chain flags, int32,
    zeroed (None for ``simt``)."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    nc = -(-S // Q)
    grads = (torch.empty_like(x), torch.empty_like(dt), torch.zeros_like(A),
             torch.empty_like(Bm), torch.empty_like(Cm))
    states = torch.empty((2, B, nc, H, N, P), dtype=torch.float32,
                         device=x.device)
    per_chunk = torch.empty((2, B, nc, H), dtype=torch.float32,
                            device=x.device)
    flags = (torch.zeros(2 + 2 * B * H * nc, dtype=torch.int32,
                         device=x.device) if wgmma else None)
    return grads, (states, per_chunk, flags)


def check_bwd(dtype: torch.dtype, N: int, P: int, chunk: int) -> None:
    """Raise unless the backward takes (dtype, N, P, chunk): the simt
    variant's chunk kernel holds a chunk's tiles and one state [N, P] in one
    block's shared memory."""
    _build.require(dtype in _build.DTYPE_CODES, "ssd_chunk_bwd",
                   f"dtype must be one of {list(_build.DTYPE_CODES)}, got "
                   f"{dtype}")
    smem = bwd_smem(dtype, N, P, chunk)
    _build.require(smem <= MAX_SMEM, "ssd_chunk_bwd",
                   f"N {N}, P {P} and chunk {min(chunk, MAX_CHUNK)} need "
                   f"{smem} bytes of shared memory, more than a block's "
                   f"{MAX_SMEM}")


def ssd_chunk_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  Bm: torch.Tensor, Cm: torch.Tensor, dy: torch.Tensor,
                  dstate: Optional[torch.Tensor] = None,
                  chunk: int = MAX_CHUNK) -> Tuple[torch.Tensor, ...]:
    """The gradients of :func:`ssd_chunk`'s (y, final state) given dy
    [B, S, H, P] (x's dtype) and dstate [B, H, N, P] f32 (None: zero), for
    the same inputs and ``chunk``. -> (dx, ddt, dA, dB, dC): dx, dB, dC in
    x's dtype, ddt [B, S, H] and dA [H] f32.

    Two variants, each deterministic (two runs give the same bits). wgmma:
    a forward chain of the chunk states and a reverse chain of their
    gradients, each block taking its chunk from an ordered ticket and
    passing its state on through device memory under a flag, with every
    product on the tensor cores (f32 operands split into two bf16 ones);
    the latency of each chunk block's steps bounds it. simt: four CUDA-core
    kernels (each chunk's increments of the state and of its gradient,
    their scan, each chunk's gradients, a fixed-order sum of dA), bound by
    f32 arithmetic. Launches on the current stream; raises on any input it
    does not take and on a failed launch."""
    global bwd_launches
    name = "ssd_chunk_bwd"
    _build.require(x.dim() == 4, name,
                   f"x must be [B, S, H, P], got {tuple(x.shape)}")
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    _build.require(dt.shape == (B, S, H) and A.shape == (H,)
                   and Bm.shape == (B, S, H, N) and Cm.shape == Bm.shape
                   and dy.shape == x.shape, name,
                   f"dt must be [B, S, H], A [H], B/C [B, S, H, N] and dy "
                   f"like x {tuple(x.shape)}, got {tuple(dt.shape)} / "
                   f"{tuple(A.shape)} / {tuple(Bm.shape)} / "
                   f"{tuple(Cm.shape)} / {tuple(dy.shape)}")
    _build.require(0 < N <= MAX_STATE_DIM and 0 < P <= MAX_STATE_DIM, name,
                   f"N and P must be in 1..{MAX_STATE_DIM}, got {N}, {P}")
    _build.require(chunk >= 1, name, f"chunk must be >= 1, got {chunk}")
    _build.check_tensors(name, [x, Bm, Cm, dy], [])
    fp32 = [dt, A] + ([dstate] if dstate is not None else [])
    _build.check_tensors(name, fp32, [])
    _build.require(dt.dtype == torch.float32 and dt.device == x.device,
                   name, "dt, A and dstate must be float32 on x's device")
    _build.require(dstate is None or dstate.shape == (B, H, N, P), name,
                   f"dstate must be [B, H, N, P], got "
                   f"{None if dstate is None else tuple(dstate.shape)}")
    Q = min(chunk, MAX_CHUNK)
    check_bwd(x.dtype, N, P, Q)
    which = bwd_variant(x.dtype, N, P, Q)
    if which == "wgmma":
        _build.check_aligned(name, [x, Bm, Cm, dy])
    grads, (states, per_chunk, flags) = allocate_bwd(x, dt, A, Bm, Cm, Q,
                                                     which == "wgmma")
    dx, ddt, dA, dB, dC = grads
    if B == 0 or S == 0 or H == 0:
        return grads
    err = _bwd_fn()(
        _build.DTYPE_CODES[x.dtype], x.data_ptr(), dt.data_ptr(),
        A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dy.data_ptr(),
        dstate.data_ptr() if dstate is not None else None, dx.data_ptr(),
        ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
        states[0].data_ptr(), states[1].data_ptr(), per_chunk[0].data_ptr(),
        per_chunk[1].data_ptr(),
        flags.data_ptr() if flags is not None else None, B, S, H, P, N, Q,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, name)
    bwd_launches += 1
    bwd_launches_by_variant[which] += 1
    return dx, ddt, dA, dB, dC
