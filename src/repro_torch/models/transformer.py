"""Model assembly for dense self-attention stacks and attention-free Mamba2
stacks: embedding / LM head, monolithic prefill, chunked prefill and paged
decode through the KV arena, the on-device multi-token decode horizon, and
the dense one-token decode of a recurrent state cache.

The reference (``repro/models/transformer.py``) stacks the layers of each
repeated group and scans over them; here the layers are an
``nn.ModuleList`` walked by a Python loop. Attention layer ``a`` (counted
among attention layers) is layer ``a`` of the arena plane, and SSM layer
``j`` (counted among SSM layers) is entry ``j`` of the state cache.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models.common import pad_vocab, rms_norm

FAMILIES = ("dense", "ssm")


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Block(nn.Module):
    """One layer's parameters in the reference's names and layout: ``attn``
    and ``ffn`` for an attention layer, ``ssm`` for a Mamba2 layer (which
    has no FFN); the parts a layer lacks are None."""

    def __init__(self, parts: Dict[str, Dict[str, torch.Tensor]]):
        super().__init__()
        self.mixer = "attn" if "attn" in parts else "ssm"
        for name in ("attn", "ffn", "ssm"):
            leaves = parts.get(name)
            setattr(self, name, None if leaves is None else nn.ParameterDict(
                {k: _frozen(v) for k, v in leaves.items()}))


class Model(nn.Module):
    """A decoder bound to one ``ArchConfig`` and holding its weights
    (inference only: no parameter requires a gradient): a dense
    self-attention stack or an attention-free Mamba2 stack.

    The serving methods take and update in place the arena planes
    ``k_pages``/``v_pages`` ``[n_attn_layers, n_rows, page, Hkv, hd]`` and
    the state cache of :meth:`state_cache`.
    """

    def __init__(self, cfg: ArchConfig, params: Dict[str, Any]):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"{cfg.name}: the port serves the {FAMILIES} families, not "
                f"family {cfg.family!r}")
        self.cfg = cfg
        self.vocab_padded = pad_vocab(cfg.vocab, 256)
        self.embedding = _frozen(params["embed"])
        self.final_ln = _frozen(params["final_ln"])
        self.lm_head = (None if cfg.tie_embeddings
                        else _frozen(params["lm_head"]))
        self.layers = nn.ModuleList(Block(lp) for lp in params["layers"])
        if len(self.layers) != cfg.n_layers:
            raise ValueError(f"{len(self.layers)} layers of parameters for "
                             f"a {cfg.n_layers}-layer config")
        self.n_ssm_layers = sum(b.mixer == "ssm" for b in self.layers)

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
    def prefill(self, tokens: torch.Tensor) -> Tuple[
            torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
        """tokens [B,P] -> (last-token logits [B,Vp] f32, k, v
        [n_attn_layers, B, P, Hkv, hd]: the prompt's K/V, layer-stacked;
        None for a model without attention layers)."""
        logits, k, v, _ = self.prefill_with_state(tokens)
        return logits, k, v

    def prefill_with_state(self, tokens: torch.Tensor):
        """:meth:`prefill`, plus the SSM layers' decode cache: ``{"state":
        [n_ssm_layers, B, H, N, P] f32, "conv": [n_ssm_layers, B,
        conv_dim-1, di]}``, or None for a model without SSM layers."""
        cfg = self.cfg
        x = self.embed(tokens)
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
        ks, vs, states, convs = [], [], [], []
        for blk in self.layers:
            if blk.mixer == "attn":
                o, k, v = L.attn_full(blk.attn, x, cfg, positions)
                x = x + o
                ks.append(k)
                vs.append(v)
                x = x + L.ffn_apply(blk.ffn, x, cfg)
            else:
                o, c = M2.ssm_full(blk.ssm, x, cfg)
                x = x + o
                states.append(c["state"])
                convs.append(c["conv"])
        x = rms_norm(x, self.final_ln, cfg.norm_eps)
        kv = (torch.stack(ks), torch.stack(vs)) if ks else (None, None)
        state = ({"state": torch.stack(states), "conv": torch.stack(convs)}
                 if states else None)
        return (self._logits(x[:, -1]), *kv, state)

    def _require_paged(self, what: str) -> None:
        if not self.supports_chunked_prefill:
            raise NotImplementedError(
                f"{self.cfg.name}: {what} needs every layer's context in "
                f"paged self-attention KV")

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
        self._require_paged("chunked prefill")
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
    @property
    def supports_prefix_reuse(self) -> bool:
        """Only a pure causal self-attention stack can resume a prompt from
        cached pages: SSM state is positionally recurrent."""
        return self.n_ssm_layers == 0

    @property
    def supports_chunked_prefill(self) -> bool:
        """Chunked prefill needs the whole prompt context in paged
        self-attention KV: the prefix-reuse rule."""
        return self.supports_prefix_reuse

    @property
    def supports_decode_horizon(self) -> bool:
        """The horizon loop carries only pages and positions between
        iterations: the prefix-reuse rule (SSM models decode one token at
        a time)."""
        return self.supports_prefix_reuse

    def paged_kv_layout(self) -> Tuple[int, int, int, torch.dtype]:
        """Self-attention KV geometry for the serving arena:
        ``(n_layers, Hkv, hd, dtype)``; attention layer ``a`` is layer ``a``
        of the plane. ``n_layers == 0`` means nothing to page (a pure-SSM
        model holds recurrent state only)."""
        cfg = self.cfg
        return (cfg.n_layers - self.n_ssm_layers, cfg.n_kv_heads,
                cfg.head_dim_, cfg.dtype)

    def decode_step_paged(self, k_pages, v_pages, block_tables, seq_lens,
                          rows, offs, tokens, positions, attend,
                          inline: bool = False) -> torch.Tensor:
        """One token for every sequence through the paged arena.
        tokens [B,1]; positions [B] the new token's position; seq_lens [B]
        int32 (positions + 1, 1 for idle lanes); rows/offs [B] its write
        coordinate. ``attend`` is the paged attention
        (``kernels.ops.paged_attention``). Returns logits [B,Vp] f32."""
        self._require_paged("paged decode")
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
        self._require_paged("the decode horizon")
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

    # ------------------------------------------------ dense state decode
    def state_cache(self, batch: int) -> Dict[str, torch.Tensor]:
        """A zeroed decode cache for the SSM layers of ``batch`` lanes:
        ``{"state": [n_ssm_layers, batch, H, N, P] f32, "conv":
        [n_ssm_layers, batch, conv_dim-1, di]}`` (the reference's
        ``state_cache_specs`` minus the stacking by group); ``{}`` for a
        model without SSM layers."""
        if not self.n_ssm_layers:
            return {}
        s, D = self.cfg.ssm, self.cfg.d_model
        n, dev = self.n_ssm_layers, self.device
        return {
            "state": torch.zeros((n, batch, s.n_heads(D), s.d_state,
                                  s.head_dim), dtype=torch.float32,
                                 device=dev),
            "conv": torch.zeros((n, batch, s.conv_dim - 1, s.d_inner(D)),
                                dtype=self.cfg.dtype, device=dev),
        }

    def decode_step(self, state_cache: Dict[str, torch.Tensor],
                    tokens: torch.Tensor, positions: torch.Tensor
                    ) -> torch.Tensor:
        """One token for every lane of a model whose layers all decode from
        the dense state cache (:meth:`state_cache`, updated in place).
        tokens [B,1]; positions [B] (unused by SSM layers, kept for the
        reference's signature). Returns logits [B,Vp] f32."""
        if self.n_ssm_layers != len(self.layers):
            raise NotImplementedError(
                f"{self.cfg.name}: attention layers decode through the "
                f"paged arena (decode_step_paged)")
        cfg = self.cfg
        x = self.embed(tokens)
        for j, blk in enumerate(self.layers):
            x = x + M2.ssm_decode(blk.ssm, x, state_cache["state"][j],
                                  state_cache["conv"][j], cfg)
        x = rms_norm(x, self.final_ln, cfg.norm_eps)
        return self._logits(x[:, 0])
