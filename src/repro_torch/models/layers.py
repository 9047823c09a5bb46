"""Transformer building blocks: GQA attention (full self- or
cross-attention, paged decode, paged chunk, dense-cache decode, cross
decode) and the dense SwiGLU / GELU FFNs. (The Mamba2 block is
``models/mamba2.py``.)

Plain functions on tensors, one per reference function in
``repro/models/layers.py``, with the same cast points. The paged functions
update the arena plane in place, where the reference returns a new
(donated) plane.

Tensor parallelism (Megatron): the head counts are read off the weights,
so a function given one rank's block of the heads (``wq``/``wk``/``wv``
columns, ``wo`` rows: its query and KV heads of
:func:`repro_torch.distributed.sharding.head_layout`, ``H/tp`` and
``Hkv/tp``, or one KV head shared with the other ranks of its group and
that group's query heads on this rank) attends over those heads alone, and an FFN given its block of ``d_ff`` computes that
block. Their output products (``wo``, ``w_down``) are then partial sums,
which :func:`attn_full`, :func:`attn_decode`, :func:`attn_decode_cross`
and :func:`ffn_apply` add up over ``model`` when given a live ``ctx``
(:func:`repro_torch.distributed.collectives.all_reduce_sum`); without
one they are the one-card functions. Under autograd the normed rows (and
the qk-norm scales) enter the rank's block through
:func:`~repro_torch.distributed.collectives.enter`, so their gradients are
summed over ``model``, and the all-reduce's backward is the identity. A
replicated KV head's weights (``wk``/``wv``/``bk``/``bv``) enter the
ranks that share it through the ``"kv"`` line, so their gradient is
summed over those ranks.

The reference's other two modes (:mod:`repro_torch.distributed.sharding`):
with ``sp`` (``tp_sp_opt``'s prefill and training), :func:`attn_full` and
:func:`ffn_apply` take the rank's rows of the sequence, all-gather the
normed rows over ``model`` once and reduce-scatter the partial sums back
to the rank's rows, in place of the all-reduce.
:func:`attn_context_parallel` is ``fsdp_cp``'s prefill and training
attention (whole weights, the rank's query rows, K/V rows gathered along
the sequence, the causal diagonal shifted by the rank's first row), and
:func:`attn_decode_stationary` / :func:`ffn_decode_stationary` its
weight-stationary decode step over the sequence-split cache.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import collectives as C
from repro_torch.kernels import ops
from repro_torch.models.common import apply_rope, rms_norm


def _project_qkv(p: Mapping[str, torch.Tensor], h: torch.Tensor,
                 src: torch.Tensor, cfg: ArchConfig, cross: bool = False,
                 ctx=None):
    """Project to q [B,S,H,hd] from ``h``, k/v [B,Sk,Hkv,hd] from ``src``
    (``h`` itself for self-attention); apply qk-norm + biases, which a
    cross-attention has not. H and Hkv are the heads the weights hold: on
    a live ``ctx`` this rank's, so the qk-norm scales, whole on every
    rank, enter the rank's heads (their gradient summed over
    ``model``), and the K/V weights enter the ranks sharing their heads
    (their gradient summed over ``"kv"``)."""
    hd = cfg.head_dim_
    H, Hkv = p["wq"].shape[1] // hd, p["wk"].shape[1] // hd
    kv = lambda name: C.enter(p[name], "kv", ctx)
    q = h @ p["wq"]
    k = src @ kv("wk")
    v = src @ kv("wv")
    if cfg.qkv_bias and not cross:
        q = q + p["bq"]
        k = k + kv("bk")
        v = v + kv("bv")
    q = q.reshape(*h.shape[:-1], H, hd)
    k = k.reshape(*src.shape[:-1], Hkv, hd)
    v = v.reshape(*src.shape[:-1], Hkv, hd)
    if cfg.qk_norm and not cross:
        q = rms_norm(q, C.enter(p["qn"], "tp", ctx), cfg.norm_eps)
        k = rms_norm(k, C.enter(p["kn"], "tp", ctx), cfg.norm_eps)
    return q, k, v


def attn_full(p, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor,
              kv_src: Optional[torch.Tensor] = None, causal: bool = True,
              ctx=None, sp: bool = False):
    """Full-sequence self- or cross-attention through
    :func:`repro_torch.kernels.ops.flash_attention` on the un-repeated K/V.

    Self-attention (``kv_src`` None) projects q/k/v from the normed ``x``
    and ropes them at ``positions``: the decoder's prefill is causal, the
    encoder's not. Cross-attention projects k/v from the raw ``kv_src``
    [B,Sk,C] (the encoder's output or the patch embeddings) and never
    ropes; its caller passes ``causal=False``. On a live ``ctx`` the
    weights are this rank's heads, the normed rows (and ``kv_src``, which
    feeds every rank's heads) enter them, their gradients summed over
    ``model``, and the output is summed over ``model``. With ``sp``
    (``tp_sp_opt``'s prefill, self-attention) ``x`` is the rank's rows of
    the sequence: the normed rows are all-gathered over ``model`` and the
    output reduce-scattered back to the rank's rows. Returns (output
    [B,S,D], k, v [B,Sk,Hkv,hd] for the cache)."""
    cross = kv_src is not None
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    h = C.all_gather(h, "tp", 1, ctx) if sp else C.enter(h, "tp", ctx)
    if cross:
        kv_src = C.enter(kv_src, "tp", ctx)
    q, k, v = _project_qkv(p, h, kv_src if cross else h, cfg, cross, ctx)
    if not cross:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    o = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=causal)
    o = o.reshape(*h.shape[:-1], q.shape[-2] * cfg.head_dim_) @ p["wo"]
    if sp:
        return C.reduce_scatter(o, "tp", 1, ctx), k, v
    return C.all_reduce_sum(o, "tp", ctx), k, v


def attn_context_parallel(p, x: torch.Tensor, cfg: ArchConfig,
                          positions: torch.Tensor, ctx):
    """``fsdp_cp``'s prefill self-attention (the reference's ``attn_full``
    in that mode): ``p`` the layer's whole weights, x [B, s, D] the rank's
    rows of the batch and its block of s = S / tp rows of the sequence at
    ``positions`` [1, s]. q, k and v of every head from the rank's rows;
    K/V all-gathered over ``model`` along the sequence to [B, S, Hkv, hd];
    flash attention of the rank's queries over them, the causal diagonal
    shifted by the rank's first row (``q_offset``). No collective on the
    output. Under autograd the qk-norm scales enter the rank's rows (their
    gradient summed over ``model``), and the K/V gathers' backward
    reduce-scatters every rank's gradient of the whole sequence's K/V to
    the rank's rows. Returns (output [B, s, D], the rank's rows of k and v
    [B, s, Hkv, hd]: the sequence-split cache's)."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q, k, v = _project_qkv(p, h, h, cfg, ctx=ctx)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    kf = C.all_gather(k.contiguous(), "tp", 1, ctx)
    vf = C.all_gather(v.contiguous(), "tp", 1, ctx)
    o = ops.flash_attention(q.contiguous(), kf, vf, causal=True,
                            q_offset=ctx.index("tp") * x.shape[1])
    del kf, vf
    o = o.reshape(*x.shape[:-1], q.shape[-2] * cfg.head_dim_)
    return o @ p["wo"], k, v


def norm_split(x: torch.Tensor, scale: torch.Tensor, cfg: ArchConfig,
               ctx) -> torch.Tensor:
    """``rms_norm`` of rows whose ``D`` is split over ``data`` (``fsdp_cp``'s
    decode residual): x [..., D/dp] this rank's block, ``scale`` [D] whole.
    The sum of squares is summed over ``data`` and divided by the whole
    ``D``."""
    n = x.shape[-1]
    xf = x.float()
    sq = C.all_reduce_sum(xf.square().sum(dim=-1, keepdim=True), "fsdp",
                          ctx)
    var = sq / (n * ctx.axis_size("fsdp"))
    w = scale.narrow(0, ctx.index("fsdp") * n, n)
    return (xf * torch.rsqrt(var + cfg.norm_eps) * w.float()).to(x.dtype)


def _stationary(h: torch.Tensor, w: torch.Tensor, ctx) -> torch.Tensor:
    """A weight-stationary product: h [..., D/dp] against the rank's block
    w [D/dp, n/tp], the partial sums over ``data`` all-reduced."""
    return C.all_reduce_sum(h @ w, "fsdp", ctx)


def attn_decode_stationary(p, x: torch.Tensor, cfg: ArchConfig,
                           positions: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, page: int,
                           lanes: Tuple[int, int], ctx) -> torch.Tensor:
    """``fsdp_cp``'s decode attention (the reference's ``attn_decode`` in
    that mode), weight-stationary over a sequence-split cache.

    x [B, 1, D/dp]: every lane, the rank's block of ``D``; ``p`` the
    rank's blocks, ``wq``/``wk``/``wv`` [D/dp, cols/tp] and ``wo`` [H hd/tp,
    D/dp]; ``lanes`` the rank's lanes ``lo, hi`` of the B; positions [hi -
    lo] their new tokens' positions; k/v_cache [hi - lo, S/tp, Hkv, hd]
    the rank's block of rows of every head (rank m of ``model`` holds rows
    m S/tp ..).

    Each projection's partial sums are all-reduced over ``data``, its
    columns of the rank's lanes all-gathered over ``model``: q, k and v of
    every head. The new token's K/V is written by the rank holding its
    position. Each rank attends over its rows (``ops.paged_attention``
    through :func:`dense_table`, lengths clamped to its rows, 0 where it
    holds none) and gets each row's log-sum-exp; the ranks' outputs are
    merged by them over ``model`` (max, rescale, sum). The output's
    columns of the rank's ``wo`` rows, all-gathered over ``data`` to every
    lane, go through ``wo``, whose partial sums are all-reduced over
    ``model``. No weight is gathered. Returns [B, 1, D/dp]."""
    hd = cfg.head_dim_
    lo, hi = lanes
    b, S_loc = k_cache.shape[0], k_cache.shape[1]
    m = ctx.index("tp")
    h = norm_split(x, p["ln"], cfg, ctx)

    def proj(w: str, bias: str) -> torch.Tensor:
        y = _stationary(h, p[w], ctx)[lo:hi]
        if cfg.qkv_bias:
            y = y + p[bias]
        return C.all_gather(y, "tp", 2, ctx)

    q, k_new, v_new = proj("wq", "bq"), proj("wk", "bk"), proj("wv", "bv")
    q = q.reshape(b, 1, -1, hd)
    k_new = k_new.reshape(b, 1, -1, hd)
    v_new = v_new.reshape(b, 1, -1, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["qn"], cfg.norm_eps)
        k_new = rms_norm(k_new, p["kn"], cfg.norm_eps)
    q = apply_rope(q, positions[:, None], cfg.rope_theta)
    k_new = apply_rope(k_new, positions[:, None], cfg.rope_theta)
    # the new token's row, written where this rank holds its position
    local = positions.long() - m * S_loc
    own = ((local >= 0) & (local < S_loc))[:, None, None]
    rows = local.clamp(0, S_loc - 1)
    ids = torch.arange(b, device=x.device)
    k_cache[ids, rows] = torch.where(own, k_new[:, 0].to(k_cache.dtype),
                                     k_cache[ids, rows])
    v_cache[ids, rows] = torch.where(own, v_new[:, 0].to(v_cache.dtype),
                                     v_cache[ids, rows])
    bt, _ = dense_table(b, S_loc, page, positions)
    seq_lens = (local + 1).clamp(0, S_loc).int()
    shape = (b * S_loc // page, page) + k_cache.shape[2:]
    o, lse = ops.paged_attention(q[:, 0].contiguous(), k_cache.view(shape),
                                 v_cache.view(shape), bt, seq_lens,
                                 return_lse=True)              # [b, H, hd]
    # merge the ranks' shares of each row: exp(lse - max) weighs a rank
    # holding none of the lane's rows 0
    w = torch.exp(lse - C.all_reduce_max(lse, "tp", ctx))[..., None]
    acc = C.all_reduce_sum(torch.cat([o.float() * w, w], dim=-1), "tp",
                           ctx)
    o = (acc[..., :hd] / acc[..., hd:]).to(x.dtype).reshape(b, 1, -1)
    n = p["wo"].shape[0]
    o = C.all_gather(o.narrow(2, m * n, n).contiguous(), "batch", 0, ctx) \
        if hi - lo < x.shape[0] else o.narrow(2, m * n, n)
    return C.all_reduce_sum(o @ p["wo"], "tp", ctx)


def ffn_decode_stationary(p, x: torch.Tensor, cfg: ArchConfig,
                          ctx) -> torch.Tensor:
    """``fsdp_cp``'s weight-stationary decode FFN (the reference's
    ``ffn_apply`` on a ``[B, 1, D]`` row in that mode): x [B, 1, D/dp], the
    rank's blocks ``w_up``/``w_gate`` [D/dp, F/tp] and ``w_down`` [F/tp,
    D/dp]; the up and gate products' partial sums all-reduced over
    ``data``, the down product's over ``model``. Returns [B, 1, D/dp]."""
    h = norm_split(x, p["ln"], cfg, ctx)
    up = _stationary(h, p["w_up"], ctx)
    if cfg.ffn_gelu:
        act = F.gelu(up, approximate="tanh")
    else:
        act = F.silu(_stationary(h, p["w_gate"], ctx)) * up
    return C.all_reduce_sum(act @ p["w_down"], "tp", ctx)


def attn_decode_cross(p, x: torch.Tensor, cfg: ArchConfig,
                      k: torch.Tensor, v: torch.Tensor,
                      ctx=None) -> torch.Tensor:
    """Single-token cross-attention against a lane's static context K/V
    (the reference's ``attn_decode(..., cross=True)``): x [B,1,D]; k/v
    [B,n_ctx,Hkv,hd], the prompt's cross K/V in the state cache. No rope,
    no mask, no write: one query row per lane through
    :func:`repro_torch.kernels.ops.flash_attention`, non-causal. On a live
    ``ctx`` ``wq``/``wo`` and k/v hold this rank's heads and the output is
    summed over ``model``. Returns the output [B,1,D]."""
    hd = cfg.head_dim_
    H = p["wq"].shape[1] // hd
    h = C.enter(rms_norm(x, p["ln"], cfg.norm_eps), "tp", ctx)
    q = (h @ p["wq"]).reshape(*h.shape[:-1], H, hd)
    o = ops.flash_attention(q.contiguous(), k, v, causal=False)
    return C.all_reduce_sum(o.reshape(*x.shape[:-1], H * hd) @ p["wo"],
                            "tp", ctx)


def attn_decode_paged(p, x: torch.Tensor, cfg: ArchConfig,
                      positions: torch.Tensor, k_pages: torch.Tensor,
                      v_pages: torch.Tensor, layer: int,
                      block_table: torch.Tensor, seq_lens: torch.Tensor,
                      rows: torch.Tensor, offs: torch.Tensor, attend,
                      inline: bool = False) -> torch.Tensor:
    """Single-token decode attention against the paged KV arena.

    x [B,1,D]; k/v_pages [L, n_rows, page, Hkv, hd] the arena plane, written
    in place; ``layer`` this layer's index into it; block_table [B, W]
    int32; rows/offs [B] the new token's write coordinate. The new token's
    (roped) K/V, cast to the plane dtype, is scattered into its page and
    ``attend`` reads through the block table. With ``inline`` it is handed
    to ``attend`` as ``k_new``/``v_new`` as well, so the read does not wait
    on the scatter; outputs are bitwise equal either way.
    Returns the output [B,1,D].
    """
    B = x.shape[0]
    H, hd = cfg.n_heads, cfg.head_dim_
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q, k_new, v_new = _project_qkv(p, h, h, cfg)
    q = apply_rope(q, positions[:, None], cfg.rope_theta)
    k_new = apply_rope(k_new, positions[:, None], cfg.rope_theta)
    k_row = k_new[:, 0].to(k_pages.dtype)
    v_row = v_new[:, 0].to(v_pages.dtype)
    rows, offs = rows.long(), offs.long()
    if inline:
        o = attend(q[:, 0].contiguous(), k_pages[layer], v_pages[layer],
                   block_table, seq_lens, k_new=k_row.contiguous(),
                   v_new=v_row.contiguous())
        k_pages[layer, rows, offs] = k_row
        v_pages[layer, rows, offs] = v_row
    else:
        k_pages[layer, rows, offs] = k_row
        v_pages[layer, rows, offs] = v_row
        o = attend(q[:, 0].contiguous(), k_pages[layer], v_pages[layer],
                   block_table, seq_lens)                     # [B, H, hd]
    o = o.reshape(B, 1, H * hd).to(x.dtype)
    return o @ p["wo"]


def dense_table(B: int, S: int, page: int, positions: torch.Tensor):
    """The paged view of a dense per-lane cache [B, S, ...] (S a multiple
    of ``page``): lane b's block table ``b * (S / page) + arange(S / page)``
    [B, S / page] int32 into the cache viewed as ``[B * S / page, page,
    ...]``, and its sequence lengths ``positions + 1`` int32."""
    W = S // page
    dev = positions.device
    bt = (torch.arange(B, device=dev)[:, None] * W
          + torch.arange(W, device=dev)[None]).int()
    return bt, (positions + 1).int()


def attn_decode(p, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor,
                k_cache: torch.Tensor, v_cache: torch.Tensor,
                block_table: torch.Tensor, seq_lens: torch.Tensor,
                page: int, attend, ctx=None) -> torch.Tensor:
    """Single-token decode attention against a dense per-lane KV cache (the
    reference's ``attn_decode`` with ``update_kv_cache``): x [B,1,D];
    k/v_cache [B, S, Hkv, hd], written in place at ``positions`` [B] (the
    new token's index) before the read. The read is ``attend`` (the paged
    attention, ``kernels.ops.paged_attention``) over the cache viewed as
    pages of ``page`` rows through :func:`dense_table`'s block table and
    sequence lengths, which cover positions ``0..positions[b]`` of lane b.
    On a live ``ctx`` the weights and the cache hold this rank's heads and
    the output is summed over ``model``. Returns the output [B,1,D]."""
    B, S, Hkv, hd = k_cache.shape
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q, k_new, v_new = _project_qkv(p, h, h, cfg, ctx=ctx)
    q = apply_rope(q, positions[:, None], cfg.rope_theta)
    k_new = apply_rope(k_new, positions[:, None], cfg.rope_theta)
    lanes = torch.arange(B, device=x.device)
    k_cache[lanes, positions.long()] = k_new[:, 0].to(k_cache.dtype)
    v_cache[lanes, positions.long()] = v_new[:, 0].to(v_cache.dtype)
    shape = (B * S // page, page, Hkv, hd)
    o = attend(q[:, 0].contiguous(), k_cache.view(shape),
               v_cache.view(shape), block_table, seq_lens)     # [B, H, hd]
    out = o.reshape(B, 1, q.shape[-2] * hd).to(x.dtype) @ p["wo"]
    return C.all_reduce_sum(out, "tp", ctx)


def attn_chunk_paged(p, x: torch.Tensor, cfg: ArchConfig,
                     positions: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor, layer: int,
                     block_table: torch.Tensor, rows: torch.Tensor,
                     offs: torch.Tensor, attend) -> torch.Tensor:
    """Chunked-prefill attention against the paged KV arena.

    x [B,C,D] one fixed-width chunk per sequence; positions [B,C] int32
    absolute positions (pad columns repeat 0); rows/offs [B,C] the chunk's
    write coordinates (pad columns point at the null row). The chunk's K/V
    is scattered into its pages first, then ``attend`` reads earlier chunks
    and this one through the block table under a causal mask.
    Returns the output [B,C,D].
    """
    B, C = x.shape[0], x.shape[1]
    H, hd = cfg.n_heads, cfg.head_dim_
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q, k_new, v_new = _project_qkv(p, h, h, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k_new = apply_rope(k_new, positions, cfg.rope_theta)
    rows, offs = rows.long(), offs.long()
    k_pages[layer, rows, offs] = k_new.to(k_pages.dtype)
    v_pages[layer, rows, offs] = v_new.to(v_pages.dtype)
    o = attend(q.contiguous(), k_pages[layer], v_pages[layer], block_table,
               positions)                                     # [B, C, H, hd]
    o = o.reshape(B, C, H * hd).to(x.dtype)
    return o @ p["wo"]


def ffn_apply(p, x: torch.Tensor, cfg: ArchConfig,
              gelu: Optional[bool] = None, ctx=None,
              sp: bool = False) -> torch.Tensor:
    """SwiGLU, or the 2-matrix GELU MLP (``gelu``, by default
    ``cfg.ffn_gelu``; the encoder's is always GELU) with the tanh
    approximation that ``jax.nn.gelu`` uses by default. On a live ``ctx``
    the weights are this rank's block of ``d_ff``, the normed rows enter
    it (their gradient summed over ``model``) and the output is summed
    over ``model``. With ``sp`` (``tp_sp_opt``'s prefill) ``x`` is the
    rank's rows of the sequence, gathered over ``model`` once normed, and
    the output is reduce-scattered back to them."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    h = C.all_gather(h, "tp", 1, ctx) if sp else C.enter(h, "tp", ctx)
    up = h @ p["w_up"]
    if cfg.ffn_gelu if gelu is None else gelu:
        act = F.gelu(up, approximate="tanh")
    else:
        act = F.silu(h @ p["w_gate"]) * up
    out = act @ p["w_down"]
    if sp:
        return C.reduce_scatter(out, "tp", 1, ctx)
    return C.all_reduce_sum(out, "tp", ctx)
