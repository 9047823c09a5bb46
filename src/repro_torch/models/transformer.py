"""Model assembly for dense self-attention stacks: embedding / LM head,
monolithic prefill, chunked prefill and paged decode through the KV arena,
and the on-device multi-token decode horizon.

The reference (``repro/models/transformer.py``) stacks the layers of each
repeated group and scans over them; here the layers are an
``nn.ModuleList`` walked by a Python loop, and layer ``i`` is layer ``i``
of the arena plane.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.common import pad_vocab, rms_norm


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Block(nn.Module):
    """One layer's parameters: ``attn`` and ``ffn`` in the reference's
    names and layout."""

    def __init__(self, attn: Dict[str, torch.Tensor],
                 ffn: Dict[str, torch.Tensor]):
        super().__init__()
        self.attn = nn.ParameterDict({k: _frozen(v) for k, v in attn.items()})
        self.ffn = nn.ParameterDict({k: _frozen(v) for k, v in ffn.items()})


class Model(nn.Module):
    """A dense decoder bound to one ``ArchConfig`` and holding its weights
    (inference only: no parameter requires a gradient).

    The serving methods take and update the arena planes
    ``k_pages``/``v_pages`` ``[n_layers, n_rows, page, Hkv, hd]`` in place.
    """

    def __init__(self, cfg: ArchConfig, params: Dict[str, Any]):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"{cfg.name}: the port serves dense self-attention models "
                f"only, not family {cfg.family!r}")
        self.cfg = cfg
        self.vocab_padded = pad_vocab(cfg.vocab, 256)
        self.embedding = _frozen(params["embed"])
        self.final_ln = _frozen(params["final_ln"])
        self.lm_head = (None if cfg.tie_embeddings
                        else _frozen(params["lm_head"]))
        self.layers = nn.ModuleList(Block(lp["attn"], lp["ffn"])
                                    for lp in params["layers"])
        if len(self.layers) != cfg.n_layers:
            raise ValueError(f"{len(self.layers)} layers of parameters for "
                             f"a {cfg.n_layers}-layer config")

    @property
    def device(self) -> torch.device:
        return self.embedding.device

    # -------------------------------------------------------------- embedding
    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embedding[tokens.long()]

    def unembed_weight(self) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return self.embedding.T
        return self.lm_head

    def _logits(self, last: torch.Tensor) -> torch.Tensor:
        """[B, D] final-normed rows -> [B, Vp] f32 logits: the product in the
        model dtype, then the upcast (the reference's cast point)."""
        return (last @ self.unembed_weight()).float()

    # ---------------------------------------------------------------- prefill
    def prefill(self, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """tokens [B,P] -> (last-token logits [B,Vp] f32, k, v
        [n_layers, B, P, Hkv, hd]: the prompt's K/V, layer-stacked)."""
        cfg = self.cfg
        x = self.embed(tokens)
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
        ks, vs = [], []
        for blk in self.layers:
            o, k, v = L.attn_full(blk.attn, x, cfg, positions)
            x = x + o
            ks.append(k)
            vs.append(v)
            x = x + L.ffn_apply(blk.ffn, x, cfg)
        x = rms_norm(x, self.final_ln, cfg.norm_eps)
        return self._logits(x[:, -1]), torch.stack(ks), torch.stack(vs)

    def prefill_chunk(self, k_pages, v_pages, tokens, positions,
                      block_tables, rows, offs, last_idx, attend
                      ) -> torch.Tensor:
        """One fixed-width prefill chunk per sequence through the paged
        arena. tokens/positions [B,C] (pad columns repeat token and
        position 0 and write to the null row); block_tables [B,W] int32;
        rows/offs [B,C] the chunk's write coordinates; last_idx [B] the
        in-chunk index of each sequence's last real token. ``attend`` is the
        chunk attention (``kernels.ops.chunk_prefill_attention``).
        Returns the last-token logits [B,Vp] f32."""
        cfg = self.cfg
        x = self.embed(tokens)
        for i, blk in enumerate(self.layers):
            x = x + L.attn_chunk_paged(blk.attn, x, cfg, positions, k_pages,
                                       v_pages, i, block_tables, rows, offs,
                                       attend)
            x = x + L.ffn_apply(blk.ffn, x, cfg)
        x = rms_norm(x, self.final_ln, cfg.norm_eps)
        lanes = torch.arange(tokens.shape[0], device=x.device)
        return self._logits(x[lanes, last_idx.long()])

    # ------------------------------------------------------- paged serving
    def paged_kv_layout(self) -> Tuple[int, int, int, torch.dtype]:
        """Self-attention KV geometry for the serving arena:
        ``(n_layers, Hkv, hd, dtype)``; layer ``i`` of the model is layer
        ``i`` of the plane."""
        cfg = self.cfg
        return cfg.n_layers, cfg.n_kv_heads, cfg.head_dim_, cfg.dtype

    def decode_step_paged(self, k_pages, v_pages, block_tables, seq_lens,
                          rows, offs, tokens, positions, attend,
                          inline: bool = False) -> torch.Tensor:
        """One token for every sequence through the paged arena.
        tokens [B,1]; positions [B] the new token's position; seq_lens [B]
        int32 (positions + 1, 1 for idle lanes); rows/offs [B] its write
        coordinate. ``attend`` is the paged attention
        (``kernels.ops.paged_attention``). Returns logits [B,Vp] f32."""
        cfg = self.cfg
        x = self.embed(tokens)
        for i, blk in enumerate(self.layers):
            x = x + L.attn_decode_paged(blk.attn, x, cfg, positions, k_pages,
                                        v_pages, i, block_tables, seq_lens,
                                        rows, offs, attend, inline=inline)
            x = x + L.ffn_apply(blk.ffn, x, cfg)
        x = rms_norm(x, self.final_ln, cfg.norm_eps)
        return self._logits(x[:, 0])

    def decode_horizon(self, k_pages, v_pages, block_tables, positions,
                       last_tokens, live, rem, cap, eos, s_max: int, *,
                       attend, horizon: int, page_tokens: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Up to ``horizon`` greedy decode iterations with no host sync.

        Each iteration is :meth:`decode_step_paged` with the new token
        spliced inline, an on-device argmax, and a per-lane stop mask; the
        loop never reads a device value back, so the caller's one fetch of
        the token block is the launch's only sync.

        block_tables [B,W] int32; positions [B] int32 next write position;
        last_tokens [B] the token feeding iteration 0; live [B] bool lanes
        decoding this launch; rem [B] tokens until ``max_new``; cap [B]
        page-granted emission budget; eos [B] end token or -1. A lane
        freezes once it emits its stage-final token (rem / eos / s_max) or
        exhausts cap; frozen and idle lanes emit -1, write only to the null
        row and attend over a length-1 window whose output is discarded.

        Returns (tokens [B, horizon] int32 with -1 in frozen lanes, the
        positions after the launch).
        """
        B = block_tables.shape[0]
        dev = block_tables.device
        lanes = torch.arange(B, device=dev)
        out = torch.full((B, horizon), -1, dtype=torch.int32, device=dev)
        live = live.bool()
        pos, last = positions, last_tokens
        for h in range(horizon):
            adv = live.int()
            rows = torch.where(
                live, block_tables[lanes, (pos // page_tokens).long()], 0)
            offs = torch.where(live, pos % page_tokens, 0)
            seq_lens = torch.where(live, pos + 1, 1).int()
            logits = self.decode_step_paged(
                k_pages, v_pages, block_tables, seq_lens, rows, offs,
                last[:, None], pos, attend, inline=True)
            nxt = logits.argmax(dim=-1).int()
            out[:, h] = torch.where(live, nxt, -1)
            pos = pos + adv
            rem = rem - adv
            cap = cap - adv
            last = torch.where(live, nxt, last)
            stop = ((rem <= 0) | ((eos >= 0) & (nxt == eos))
                    | (pos >= s_max - 1) | (cap <= 0))
            live = live & ~stop
        return out, pos
