"""Plain PyTorch versions of the paged-attention kernels.

Each mirrors the reference oracle in ``repro/kernels/ref.py`` operation by
operation, dtype order included. They are what the CPU runs (the dispatch
in :mod:`repro_torch.kernels.ops` picks them for CPU tensors) and what the
CUDA kernels are held against on the card.
"""
from __future__ import annotations

import torch


def _gather(pages: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """[n_rows, page, Hkv, hd] pages through a [B, slots] block table ->
    one contiguous [B, slots*page, Hkv, hd] view per sequence."""
    B, slots = block_table.shape
    _, page, Hkv, hd = pages.shape
    return pages[block_table.long()].reshape(B, slots * page, Hkv, hd)


def paged_attention_ref(q, k_pages, v_pages, block_table, seq_lens,
                        k_new=None, v_new=None):
    """q [B,H,hd]; pages [n_rows, page, Hkv, hd]; block_table [B,slots].

    ``seq_lens`` is clamped to >= 1 (an idle slot points at the null row).
    ``k_new``/``v_new`` [B,Hkv,hd] (optional) are spliced in at position
    ``seq_len - 1`` instead of being read from the pages: elementwise equal
    to scatter-then-gather, so the output is bitwise equal too.
    """
    B, H, hd = q.shape
    _, page, Hkv, _ = k_pages.shape
    slots = block_table.shape[1]
    seq_lens = torch.clamp(seq_lens.long(), min=1)
    k = _gather(k_pages, block_table)
    v = _gather(v_pages, block_table)
    if k_new is not None:
        pos = torch.arange(slots * page, device=q.device)
        w = (pos[None, :] == (seq_lens - 1)[:, None])[..., None, None]
        k = torch.where(w, k_new[:, None].to(k.dtype), k)
        v = torch.where(w, v_new[:, None].to(v.dtype), v)
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    s = torch.einsum("bhd,bkhd->bhk", q.float(), k.float()) * (hd ** -0.5)
    valid = torch.arange(slots * page, device=q.device)[None, :] \
        < seq_lens[:, None]
    s = s.masked_fill(~valid[:, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bkhd->bhd", p, v.float()).to(q.dtype)


def chunk_prefill_attention_ref(q, k_pages, v_pages, block_table, positions):
    """Chunked-prefill attention: a chunk of C query tokens per sequence
    attends to everything already written to its pages (earlier chunks and
    this chunk, which the caller scatters first) under a causal mask on
    absolute positions. q [B,C,H,hd]; positions [B,C] -> [B,C,H,hd].

    As in the reference oracle the score dot runs in the I/O dtype and is
    cast to f32 afterwards; the kernels upcast first, so the two are
    compared at f32.
    """
    B, C, H, hd = q.shape
    _, page, Hkv, _ = k_pages.shape
    slots = block_table.shape[1]
    k = _gather(k_pages, block_table)
    v = _gather(v_pages, block_table)
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * (hd ** -0.5)
    kpos = torch.arange(slots * page, device=q.device)
    mask = positions.long()[:, :, None] >= kpos[None, None, :]
    s = s.masked_fill(~mask[:, None], float("-inf"))
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=-1e30)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bkhd->bqhd", (p / l).to(v.dtype), v)
