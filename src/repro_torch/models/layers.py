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
"""
from __future__ import annotations

from typing import Mapping, Optional

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
              ctx=None):
    """Full-sequence self- or cross-attention through
    :func:`repro_torch.kernels.ops.flash_attention` on the un-repeated K/V.

    Self-attention (``kv_src`` None) projects q/k/v from the normed ``x``
    and ropes them at ``positions``: the decoder's prefill is causal, the
    encoder's not. Cross-attention projects k/v from the raw ``kv_src``
    [B,Sk,C] (the encoder's output or the patch embeddings) and never
    ropes; its caller passes ``causal=False``. On a live ``ctx`` the
    weights are this rank's heads, the normed rows (and ``kv_src``, which
    feeds every rank's heads) enter them, their gradients summed over
    ``model``, and the output is summed over ``model``. Returns (output
    [B,S,D], k, v [B,Sk,Hkv,hd] for the cache)."""
    cross = kv_src is not None
    h = C.enter(rms_norm(x, p["ln"], cfg.norm_eps), "tp", ctx)
    if cross:
        kv_src = C.enter(kv_src, "tp", ctx)
    q, k, v = _project_qkv(p, h, kv_src if cross else h, cfg, cross, ctx)
    if not cross:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    o = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=causal)
    o = o.reshape(*x.shape[:-1], q.shape[-2] * cfg.head_dim_)
    return C.all_reduce_sum(o @ p["wo"], "tp", ctx), k, v


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
              gelu: Optional[bool] = None, ctx=None) -> torch.Tensor:
    """SwiGLU, or the 2-matrix GELU MLP (``gelu``, by default
    ``cfg.ffn_gelu``; the encoder's is always GELU) with the tanh
    approximation that ``jax.nn.gelu`` uses by default. On a live ``ctx``
    the weights are this rank's block of ``d_ff``, the normed rows enter
    it (their gradient summed over ``model``) and the output is summed
    over ``model``."""
    h = C.enter(rms_norm(x, p["ln"], cfg.norm_eps), "tp", ctx)
    up = h @ p["w_up"]
    if cfg.ffn_gelu if gelu is None else gelu:
        act = F.gelu(up, approximate="tanh")
    else:
        act = F.silu(h @ p["w_gate"]) * up
    return C.all_reduce_sum(act @ p["w_down"], "tp", ctx)
