"""Mixture-of-Experts FFN with sort-based, capacity-bucketed token dispatch.

The port of the local (no mesh) path of ``repro/models/moe.py``: routing
picks each token's top-k experts, a double argsort gives each (token, k)
pair its rank within its expert, and pairs past the expert's capacity are
dropped; dispatch and combine are gathers. The expert products are one
batched matrix product per weight over a dense ``[E, C, D]`` bucket. The
reference's expert-parallel path (``_moe_sharded``, a ``shard_map`` over a
device mesh) is not ported: one card has no mesh.

Ties keep the reference's order: ``lax.top_k`` prefers the lower expert
index among equal probabilities and ``jnp.argsort`` is stable, so routing
takes the first K of a stable descending sort and ranks with a stable
argsort.
"""
from __future__ import annotations

import math
from typing import Mapping, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.models.common import rms_norm

Info = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _capacity(n_tokens: int, n_experts: int, top_k: int, cf: float,
              dropless: bool = False) -> int:
    """Slots per expert. ``dropless`` (decode, ``S == 1``): room for every
    pair on one expert, so no pair is ever dropped."""
    if dropless:
        return n_tokens * top_k
    return max(1, math.ceil(n_tokens * top_k * cf / n_experts))


def _bincount(eflat: torch.Tensor, E: int) -> torch.Tensor:
    """Pairs per expert. On ``meta`` (the dry run) the counts have no
    values, and ``torch.bincount`` has no meta kernel (its length depends
    on the values): an empty [E] of its dtype stands in."""
    if eflat.device.type == "meta":
        return torch.empty(E, dtype=torch.int64, device="meta")
    return torch.bincount(eflat, minlength=E)


def _route_and_bucket(xt: torch.Tensor, router: torch.Tensor, E: int,
                      K: int, C: int) -> Tuple[torch.Tensor, Info]:
    """xt [T, D] -> (buf [E, C, D], combine info). The router product runs
    in the model dtype, then the f32 softmax; the gates are cast back to
    the model dtype."""
    T = xt.shape[0]
    dev = xt.device
    logits = (xt @ router).float()                        # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gvals, gidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gvals, gidx = gvals[:, :K], gidx[:, :K]               # [T, K]
    eflat = gidx.reshape(-1)                              # [T*K]
    order = torch.argsort(eflat, stable=True)
    se = eflat[order]
    counts = _bincount(eflat, E)                          # [E]
    start = torch.cumsum(counts, 0) - counts              # exclusive prefix
    rank_sorted = torch.arange(T * K, device=dev) - start[se]
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted                             # rank within expert
    keep = rank < C
    # dispatch (gather): buf[e, c] = token of the pair at sorted slot start[e]+c
    grid_c = torch.arange(C, device=dev)
    gslot = start[:, None] + grid_c[None, :]              # [E, C]
    valid = grid_c[None, :] < torch.clamp(counts, max=C)[:, None]
    pair_tok_sorted = order // K                          # token per sorted pair
    tok_idx = pair_tok_sorted[gslot.clamp(0, T * K - 1)]
    buf = torch.where(valid[..., None], xt[tok_idx], 0)
    return buf, (eflat, rank, keep, gvals.to(xt.dtype))


def _combine(out_buf: torch.Tensor, info: Info, T: int, K: int,
             C: int) -> torch.Tensor:
    """out_buf [E, C, D] -> y [T, D]: gather, then the gate-weighted sum
    over the K picks."""
    eflat, rank, keep, gvals = info
    flat = out_buf.reshape(-1, out_buf.shape[-1])         # [E*C, D]
    vals = flat[eflat * C + rank.clamp(0, C - 1)]         # [T*K, D]
    vals = torch.where(keep[:, None], vals, 0)
    return (vals.reshape(T, K, -1) * gvals[..., None]).sum(dim=1)


def _expert_ffn(buf: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                wd: torch.Tensor) -> torch.Tensor:
    """SwiGLU per expert: buf [E, C, D]; wg/wu [E, D, F]; wd [E, F, D]."""
    return torch.bmm(F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu), wd)


def _moe_local(p: Mapping[str, torch.Tensor], x: torch.Tensor,
               moe: MoEConfig) -> torch.Tensor:
    B, S, D = x.shape
    T = B * S
    E, K = moe.n_experts, moe.top_k
    C = _capacity(T, E, K, moe.capacity_factor, dropless=(S == 1))
    buf, info = _route_and_bucket(x.reshape(T, D), p["router"], E, K, C)
    out_buf = _expert_ffn(buf, p["w_gate"], p["w_up"], p["w_down"])
    return _combine(out_buf, info, T, K, C).reshape(B, S, D)


def moe_apply(p: Mapping[str, torch.Tensor], x: torch.Tensor,
              cfg: ArchConfig) -> torch.Tensor:
    """The MoE FFN of one layer: the norm inside, the residual outside.
    x [B,S,D]; every one of the B*S rows is routed, pad rows too, and
    takes capacity as the reference's do. Returns [B,S,D]."""
    return _moe_local(p, rms_norm(x, p["ln"], cfg.norm_eps), cfg.moe)
