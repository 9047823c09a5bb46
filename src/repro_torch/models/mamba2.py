"""Mamba2 (SSD — state-space duality) block: the chunked full-sequence scan
and the single-token decode step.

Plain functions on tensors, one per reference function in
``repro/models/mamba2.py``, with the same arguments and cast points. The
full-sequence scan is
:func:`repro_torch.kernels.ops.ssd_chunk`: the CUDA kernel for tensors on
the card, the plain chunked scan for tensors on the CPU. Under grad on the
card it is :class:`~repro_torch.kernels.ops.SSDChunkFn` (the forward kernel
and the hand-written backward, ``csrc/ssd_chunk_bwd.cu``); on the CPU
autograd differentiates the plain scan.

Across a live mesh (``ctx``) the heads split over ``model``, as the
reference's specs split them: a rank's weights hold its ``H/tp`` heads
(``wdt``, ``A_log``, ``dt_bias``, ``D_skip``), its ``di/tp`` channels
(``wx``, ``wz``, ``conv``, ``gn``, the rows of ``wout``) and the whole of
``wB``/``wC``, which it reads for its own heads' groups alone. The normed
rows, ``wB`` and ``wC`` enter the rank's heads (their gradients summed
over ``model``); the gated norm's sum of squares is summed over ``model``
(its mean is over the whole ``di``, as the reference's is); the ``wout``
product is summed over ``model``. The decode cache is the rank's heads' state and channels' conv window.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import collectives as C
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


def _groups(Bm: torch.Tensor, H: int, cfg: ArchConfig,
            ctx) -> torch.Tensor:
    """[..., G, N] -> [..., H, N]: each of the ``H`` heads the weights hold
    (on a live ``ctx`` this rank's block of the heads) takes its group's
    row, as the reference's ``jnp.repeat`` over the whole heads does: the
    groups of the rank's block, each repeated over its heads there (the
    backward sums each group's heads in one reduction). The block holds
    whole groups or lies in one (:func:`~repro_torch.models.transformer.
    check_mesh`)."""
    s = cfg.ssm
    per = s.n_heads(cfg.d_model) // s.n_groups        # heads of one group
    lo = ctx.index("tp") * H if ctx is not None else 0
    g0, g1 = lo // per, -(-(lo + H) // per)
    if (g0, g1) != (0, s.n_groups):
        Bm = Bm[..., g0:g1, :]
    return Bm if H == g1 - g0 else Bm.repeat_interleave(H // (g1 - g0),
                                                        dim=-2)


def _pre(p, x: torch.Tensor, cfg: ArchConfig, ctx=None):
    """Shared projections: returns (xz [B,S,di], z, Bm/Cm [B,S,H,N],
    dt [B,S,H] f32, post-softplus); on a live ``ctx`` the rank's heads
    and channels."""
    s = cfg.ssm
    H = p["wdt"].shape[1]
    h = C.enter(rms_norm(x, p["ln"], cfg.norm_eps), "tp", ctx)
    xz = h @ p["wx"]
    z = h @ p["wz"]
    Bm = (h @ C.enter(p["wB"], "tp", ctx)).reshape(
        *h.shape[:-1], s.n_groups, s.d_state)
    Cm = (h @ C.enter(p["wC"], "tp", ctx)).reshape(
        *h.shape[:-1], s.n_groups, s.d_state)
    Bm, Cm = _groups(Bm, H, cfg, ctx), _groups(Cm, H, cfg, ctx)
    dt = F.softplus((h @ p["wdt"]).float() + p["dt_bias"])
    return xz, z, Bm, Cm, dt


def gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
               cfg: ArchConfig, ctx=None) -> torch.Tensor:
    """``rms_norm(y * silu(z), scale)`` over the whole ``di`` channels. On
    a live ``ctx`` y/z/scale hold this rank's channels: the sum of their
    squares is summed over ``model`` (its cotangent too, each rank's
    channels feeding every rank's norm) and divided by the whole
    ``di``."""
    g = y * F.silu(z)
    gf = g.float()
    sq = C.all_reduce_sum(gf.square().sum(dim=-1, keepdim=True), "tp", ctx)
    var = C.enter(sq, "tp", ctx) / cfg.ssm.d_inner(cfg.d_model)
    return (gf * torch.rsqrt(var + cfg.norm_eps) * scale.float()).to(g.dtype)


def _post(p, y: torch.Tensor, z: torch.Tensor, cfg: ArchConfig,
          ctx=None) -> torch.Tensor:
    """Gated RMS norm + out projection (row-parallel on a live ``ctx``:
    summed over ``model``). y [B,S,di]."""
    y = gated_norm(y, z, p["gn"], cfg, ctx)
    return C.all_reduce_sum(y @ p["wout"], "tp", ctx)


def conv_tail(xz: torch.Tensor, width: int) -> torch.Tensor:
    """The decode cache's conv window: the last ``width - 1`` pre-conv
    inputs, zero-padded in front for a prompt shorter than that (the zeros
    the causal conv reads there)."""
    S = xz.shape[1]
    if S < width - 1:
        xz = F.pad(xz, (0, 0, width - 1 - S, 0))
    return xz[:, -(width - 1):]


def ssm_full(p, x: torch.Tensor, cfg: ArchConfig, ctx=None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence Mamba2 block. x [B,S,D] -> (out [B,S,D], decode cache
    {"state": [B,H,N,P] f32, "conv": [B,conv_dim-1,di]}); on a live
    ``ctx`` H and di are the rank's."""
    s = cfg.ssm
    B, S, _ = x.shape
    H, P_ = p["wdt"].shape[1], s.head_dim
    xz, z, Bm, Cm, dt = _pre(p, x, cfg, ctx)
    xc = F.silu(_causal_conv(xz, p["conv"]))
    xh = xc.reshape(B, S, H, P_)
    A = -torch.exp(p["A_log"])
    y, final_state = ops.ssd_chunk(xh, dt, A, Bm.contiguous(),
                                   Cm.contiguous(), s.chunk)
    y = y + xh * p["D_skip"][None, None, :, None].to(xh.dtype)
    out = _post(p, y.reshape(B, S, -1), z, cfg, ctx)
    return out, {"state": final_state, "conv": conv_tail(xz, s.conv_dim)}


def ssm_decode(p, x: torch.Tensor, state: torch.Tensor, conv: torch.Tensor,
               cfg: ArchConfig, ctx=None) -> torch.Tensor:
    """Single-token Mamba2 step. x [B,1,D]; state [B,H,N,P] f32 and conv
    [B,conv_dim-1,di] the decode cache (on a live ``ctx`` the rank's
    heads and channels), both updated in place (the reference returns new
    arrays). Returns out [B,1,D]."""
    s = cfg.ssm
    B = x.shape[0]
    H, P_ = p["wdt"].shape[1], s.head_dim
    xz, z, Bm, Cm, dt = _pre(p, x, cfg, ctx)       # xz [B,1,di]; dt [B,1,H]
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
    return _post(p, y, z, cfg, ctx)
