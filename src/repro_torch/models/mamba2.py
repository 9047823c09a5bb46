"""Mamba2 (SSD — state-space duality) block: the chunked full-sequence scan
and the single-token decode step.

Plain functions on tensors, one per reference function in
``repro/models/mamba2.py``, with the same arguments minus the sharding
context and the same cast points. The full-sequence scan is
:func:`repro_torch.kernels.ops.ssd_chunk`: the CUDA kernel for tensors on
the card, the plain chunked scan for tensors on the CPU. Under grad on the
card it is :class:`~repro_torch.kernels.ops.SSDChunkFn` (the forward kernel
and the hand-written backward, ``csrc/ssd_chunk_bwd.cu``); on the CPU
autograd differentiates the plain scan.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.common import rms_norm


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv via shifted adds. x [B,S,C]; w [width,C]."""
    width = w.shape[0]
    out = x * w[width - 1]
    for i in range(1, width):
        shifted = F.pad(x, (0, 0, i, 0))[:, :-i]
        out = out + shifted * w[width - 1 - i]
    return out


def _pre(p, x: torch.Tensor, cfg: ArchConfig):
    """Shared projections: returns (xz [B,S,di], z, Bm/Cm [B,S,H,N],
    dt [B,S,H] f32, post-softplus)."""
    s = cfg.ssm
    H = s.n_heads(cfg.d_model)
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    xz = h @ p["wx"]
    z = h @ p["wz"]
    Bm = (h @ p["wB"]).reshape(*h.shape[:-1], s.n_groups, s.d_state)
    Cm = (h @ p["wC"]).reshape(*h.shape[:-1], s.n_groups, s.d_state)
    if s.n_groups != H:
        Bm = Bm.repeat_interleave(H // s.n_groups, dim=-2)
        Cm = Cm.repeat_interleave(H // s.n_groups, dim=-2)
    dt = F.softplus((h @ p["wdt"]).float() + p["dt_bias"])
    return xz, z, Bm, Cm, dt


def _post(p, y: torch.Tensor, z: torch.Tensor,
          cfg: ArchConfig) -> torch.Tensor:
    """Gated RMS norm + out projection. y [B,S,di]."""
    y = rms_norm(y * F.silu(z), p["gn"], cfg.norm_eps)
    return y @ p["wout"]


def conv_tail(xz: torch.Tensor, width: int) -> torch.Tensor:
    """The decode cache's conv window: the last ``width - 1`` pre-conv
    inputs, zero-padded in front for a prompt shorter than that (the zeros
    the causal conv reads there)."""
    S = xz.shape[1]
    if S < width - 1:
        xz = F.pad(xz, (0, 0, width - 1 - S, 0))
    return xz[:, -(width - 1):]


def ssm_full(p, x: torch.Tensor, cfg: ArchConfig
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence Mamba2 block. x [B,S,D] -> (out [B,S,D], decode cache
    {"state": [B,H,N,P] f32, "conv": [B,conv_dim-1,di]})."""
    s = cfg.ssm
    B, S, _ = x.shape
    H, P_ = s.n_heads(cfg.d_model), s.head_dim
    xz, z, Bm, Cm, dt = _pre(p, x, cfg)
    xc = F.silu(_causal_conv(xz, p["conv"]))
    xh = xc.reshape(B, S, H, P_)
    A = -torch.exp(p["A_log"])
    y, final_state = ops.ssd_chunk(xh, dt, A, Bm.contiguous(),
                                   Cm.contiguous(), s.chunk)
    y = y + xh * p["D_skip"][None, None, :, None].to(xh.dtype)
    out = _post(p, y.reshape(B, S, -1), z, cfg)
    return out, {"state": final_state, "conv": conv_tail(xz, s.conv_dim)}


def ssm_decode(p, x: torch.Tensor, state: torch.Tensor, conv: torch.Tensor,
               cfg: ArchConfig) -> torch.Tensor:
    """Single-token Mamba2 step. x [B,1,D]; state [B,H,N,P] f32 and conv
    [B,conv_dim-1,di] the decode cache, both updated in place (the
    reference returns new arrays). Returns out [B,1,D]."""
    s = cfg.ssm
    B = x.shape[0]
    H, P_ = s.n_heads(cfg.d_model), s.head_dim
    xz, z, Bm, Cm, dt = _pre(p, x, cfg)            # xz [B,1,di]; dt [B,1,H]
    win = torch.cat([conv, xz], dim=1)             # [B,w,di]
    xc = F.silu((win * p["conv"][None]).sum(dim=1, keepdim=True))
    xh = xc.reshape(B, H, P_).float()
    A = -torch.exp(p["A_log"])
    dt1 = dt[:, 0]                                 # [B,H]
    dA = torch.exp(dt1 * A)                        # [B,H]
    b1 = Bm[:, 0].float()                          # [B,H,N]
    c1 = Cm[:, 0].float()
    xdt = xh * dt1[..., None]                      # [B,H,P]
    new_state = (state * dA[..., None, None]
                 + torch.einsum("bhn,bhp->bhnp", b1, xdt))
    y = torch.einsum("bhn,bhnp->bhp", c1, new_state)
    y = y + xh * p["D_skip"][None, :, None]
    y = y.to(x.dtype).reshape(B, 1, -1)
    state.copy_(new_state)
    conv.copy_(win[:, 1:])
    return _post(p, y, z, cfg)
