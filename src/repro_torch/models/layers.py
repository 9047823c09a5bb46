"""Transformer building blocks: GQA attention (full, paged decode, paged
chunk) and the dense SwiGLU / GELU FFNs. (The Mamba2 block is
``models/mamba2.py``.)

Plain functions on tensors, one per reference function in
``repro/models/layers.py``, with the same arguments minus the sharding
context (one GPU, nothing to constrain) and the same cast points. The paged
functions update the arena plane in place, where the reference returns a
new (donated) plane.
"""
from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.common import apply_rope, rms_norm


def _project_qkv(p: Mapping[str, torch.Tensor], h: torch.Tensor,
                 cfg: ArchConfig):
    """Project to q [B,S,H,hd], k/v [B,S,Hkv,hd]; apply qk-norm + biases."""
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = h @ p["wq"]
    k = h @ p["wk"]
    v = h @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(*h.shape[:-1], H, hd)
    k = k.reshape(*h.shape[:-1], Hkv, hd)
    v = v.reshape(*h.shape[:-1], Hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["qn"], cfg.norm_eps)
        k = rms_norm(k, p["kn"], cfg.norm_eps)
    return q, k, v


def attn_full(p, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor):
    """Full-sequence causal self-attention (monolithic prefill) through
    :func:`repro_torch.kernels.ops.flash_attention` on the un-repeated K/V.
    Returns (output [B,S,D], k, v [B,S,Hkv,hd] for the cache)."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q, k, v = _project_qkv(p, h, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=True)
    o = o.reshape(*x.shape[:-1], cfg.n_heads * cfg.head_dim_)
    return o @ p["wo"], k, v


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
    q, k_new, v_new = _project_qkv(p, h, cfg)
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
    q, k_new, v_new = _project_qkv(p, h, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k_new = apply_rope(k_new, positions, cfg.rope_theta)
    rows, offs = rows.long(), offs.long()
    k_pages[layer, rows, offs] = k_new.to(k_pages.dtype)
    v_pages[layer, rows, offs] = v_new.to(v_pages.dtype)
    o = attend(q.contiguous(), k_pages[layer], v_pages[layer], block_table,
               positions)                                     # [B, C, H, hd]
    o = o.reshape(B, C, H * hd).to(x.dtype)
    return o @ p["wo"]


def ffn_apply(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """SwiGLU, or the 2-matrix GELU MLP (``cfg.ffn_gelu``) with the tanh
    approximation that ``jax.nn.gelu`` uses by default."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    up = h @ p["w_up"]
    if cfg.ffn_gelu:
        act = F.gelu(up, approximate="tanh")
    else:
        act = F.silu(h @ p["w_gate"]) * up
    return act @ p["w_down"]
