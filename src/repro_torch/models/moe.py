"""Mixture-of-Experts FFN with sort-based, capacity-bucketed token dispatch.

The port of ``repro/models/moe.py``'s two paths. Routing picks each
token's top-k experts, a double argsort gives each (token, k) pair its rank
within its expert, and pairs past the expert's capacity are dropped;
dispatch and combine are gathers. The expert products are one batched
matrix product per weight over a dense ``[E, C, D]`` bucket.

``_moe_local`` serves one card. ``_moe_sharded`` is the reference's
expert-parallel ``shard_map`` run by the ranks of a live mesh: each rank
routes its own tokens (its rows over ``data``, its block of the sequence
over ``model`` where that divides it) and buckets them against a capacity
of its own, ``C_loc`` from its ``T_loc`` tokens, so that pairs drop as
they drop on the reference's shards, not as on one device. The experts are
split over ``model`` and reached by two all-to-alls; the router and the
expert weights are all-gathered over ``data`` (ZeRO-3).

Ties keep the reference's order: ``lax.top_k`` prefers the lower expert
index among equal probabilities and ``jnp.argsort`` is stable, so routing
takes the first K of a stable descending sort and ranks with a stable
argsort.
"""
from __future__ import annotations

import math
from typing import List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.distributed import collectives as C
from repro_torch.models.common import rms_norm
from repro_torch.models.layers import norm_split

Info = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

# while a list, each bucketing appends its count of dropped pairs (a 0-d
# tensor on the tokens' device: no sync) and of pairs routed
drop_log: Optional[List[Tuple[torch.Tensor, int]]] = None


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
    if drop_log is not None:
        drop_log.append(((~keep).sum(), T * K))
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


def _moe_sharded(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                 moe: MoEConfig, ctx, sp: bool = False) -> torch.Tensor:
    """The reference's ``_moe_sharded`` on one rank. x [b, S, D]: the
    rank's rows over ``data`` (all B where dp does not divide it),
    replicated over ``model``; p the rank's blocks: router [D/dp, E],
    w_gate/w_up [E/tp, D/dp, F], w_down [E/tp, F, D/dp]. With ``sp`` (the
    sequence-split modes' prefill) x [b, S/tp, D] is already the rank's
    block of the sequence, routed as it comes, and so is the output.

    Under autograd the rows and the router enter this rank's block of the
    sequence (their gradients summed over ``model``), the all-to-alls run
    back reversed, the ZeRO-3 gathers reduce-scatter, and the output's
    gather keeps this rank's block of its cotangent, which the replicated
    layers after it hold whole. A sequence that ``model`` does not split
    is routed whole on every model rank, each expert then seeing every
    token once per model rank; that has no gradient here (``ValueError``
    under autograd)."""
    tp = ctx.axis_size("exp")
    b, S, D = x.shape
    E, K = moe.n_experts, moe.top_k
    if sp:
        S *= tp
    seq_shardable = S % tp == 0
    if not seq_shardable and tp > 1 and torch.is_grad_enabled() and (
            x.requires_grad or p["router"].requires_grad):
        raise ValueError(f"a sequence of {S} does not split over mesh axis "
                         f"'model' of {tp} ranks: the sharded MoE has no "
                         f"gradient for it")
    s_loc = S // tp if seq_shardable else S
    if seq_shardable and not sp:
        x = C.enter(x, "exp", ctx).narrow(1, ctx.index("exp") * s_loc, s_loc)
    T_loc = b * s_loc
    C_loc = _capacity(T_loc, E, K, moe.capacity_factor, dropless=(S == 1))
    router = C.enter(C.all_gather(p["router"], "fsdp", 0, ctx), "exp", ctx)
    buf, info = _route_and_bucket(x.reshape(T_loc, D), router, E, K, C_loc)
    # dispatch: [E, C_loc, D] -> this rank's experts [E/tp, tp * C_loc, D]
    buf = C.all_to_all(buf, "exp", 0, 1, ctx)
    wg = C.all_gather(p["w_gate"], "fsdp", 1, ctx)
    wu = C.all_gather(p["w_up"], "fsdp", 1, ctx)
    wd = C.all_gather(p["w_down"], "fsdp", 2, ctx)
    out = _expert_ffn(buf, wg, wu, wd)
    del buf, wg, wu, wd
    out = C.all_to_all(out, "exp", 1, 0, ctx)                 # [E, C_loc, D]
    y = _combine(out, info, T_loc, K, C_loc).reshape(b, s_loc, D)
    # the sequence whole again on every model rank, for the next layer
    return (C.all_gather(y, "exp", 1, ctx, grad="block")
            if seq_shardable and not sp else y)


def moe_apply(p: Mapping[str, torch.Tensor], x: torch.Tensor,
              cfg: ArchConfig, ctx=None, sp: bool = False) -> torch.Tensor:
    """The MoE FFN of one layer: the norm inside, the residual outside.
    x [B,S,D]; every one of the B*S rows is routed, pad rows too, and
    takes capacity as the reference's do. On a live ``ctx``,
    :func:`_moe_sharded` with this rank's blocks (``sp``: x the rank's rows
    of the sequence). Returns [B,S,D]."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    if ctx is not None and ctx.live:
        return _moe_sharded(p, h, cfg.moe, ctx, sp)
    return _moe_local(p, h, cfg.moe)


def moe_decode_stationary(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                          cfg: ArchConfig, ctx, split: bool) -> torch.Tensor:
    """The MoE FFN of ``fsdp_cp``'s weight-stationary decode step: x [B, 1,
    D/dp] every lane, the rank's block of ``D``; ``split`` whether the
    lanes are split over ``data``. The normed rows are resharded to the
    layout :func:`_moe_sharded` takes, the rank's lanes whole (an
    all-to-all over ``data``, or an all-gather of ``D`` where every data
    rank holds every lane), and its output back to every lane's block of
    ``D``. Returns [B, 1, D/dp]."""
    h = norm_split(x, p["ln"], cfg, ctx)
    n = h.shape[-1]
    if split:
        h = C.all_to_all(h, "batch", 0, 2, ctx)           # [B/dp, 1, D]
    else:
        h = C.all_gather(h, "batch", 2, ctx)
    y = _moe_sharded(p, h, cfg.moe, ctx)
    if split:
        return C.all_to_all(y, "batch", 2, 0, ctx)        # [B, 1, D/dp]
    return y.narrow(2, ctx.index("fsdp") * n, n)
