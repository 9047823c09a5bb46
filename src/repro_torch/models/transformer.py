"""Model assembly for every family of the zoo: dense and MoE
self-attention stacks, attention-free Mamba2 stacks and hybrids of the two,
the Whisper-style encoder-decoder and the decoder with interleaved
cross-attention layers (vlm). Embedding / LM head, the encoder, monolithic
prefill, chunked prefill and paged decode through the KV arena, the
on-device multi-token decode horizon, and the one-token decode of a
recurrent state cache.

The reference (``repro/models/transformer.py``) stacks the layers of each
repeated period slot by slot and scans over the groups; here the layers are
an ``nn.ModuleList`` walked by a Python loop. Layer ``i`` is group ``i //
period``, slot ``i % period``; its arena layer is the reference's
``bases[slot] + group`` (attention slot ``a``, in slot order, group ``g``
at ``a * n_groups + g``), and SSM layer ``j`` (counted among SSM layers) is
entry ``j`` of the state cache. Each layer applies its own FFN: dense, MoE,
or none on an SSM layer. A layer with cross-attention (every decoder
layer of an encdec model, the interleaved ones of a vlm) applies it after
its mixer and before its FFN; cross layer ``j`` (counted among cross
layers, in layer order) reads entry ``j`` of the state cache's cross K/V.

Training (``Model(cfg, params, trainable=True)``): :meth:`Model.backbone`
recomputes each layer (and each encoder layer) in the backward pass, as the
reference's ``jax.checkpoint`` over its groups does, and :meth:`Model.loss`
is the mean next-token cross-entropy with its logits chunked over the
sequence and recomputed in the backward, so ``[B, S, Vp]`` logits never
exist. Serving models are frozen: no parameter requires a gradient, so the
serving methods never build a graph.

Across a live mesh (``build_model(..., mesh=make_local_mesh(d, m))``, the
dense and MoE families): each rank holds its block of every leaf
(:meth:`ShardingCtx.shard_tree` under :meth:`Model.param_pspecs`).
:meth:`Model.prefill`, :meth:`Model.prefill_with_state` and
:meth:`Model.decode_step` then run Megatron tensor parallelism over
``model`` (heads, ``d_ff`` and the vocabulary split; the ``wo`` and
``w_down`` products all-reduced), ZeRO-3 over ``data`` (each leaf's
``fsdp`` dim all-gathered before its layer uses it) and the reference's
expert parallelism (:func:`repro_torch.models.moe._moe_sharded`), on the
rank's rows of the batch; activations are whole over ``model`` between
the layers. :meth:`Model.backbone` and :meth:`Model.loss` train the same
way: the collectives carry the gradients back
(:mod:`repro_torch.distributed.collectives`; each ZeRO-3 gather is
recomputed in the backward with its layer and reduce-scatters the
weight's gradient to this rank's block), and the loss is vocab-parallel.
The paged, chunked and horizon methods run on one card and raise on a
live mesh.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, TensorSpec
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import (ShardingCtx, param_shardings,
                                              placements)
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import moe as MOE
from repro_torch.models.common import (abstract_tree, encoder_layer_specs,
                                       layer_specs, pad_vocab, param_specs,
                                       rms_norm)
from repro_torch.tree import leaves

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
# the families that run across a live mesh
MESH_FAMILIES = ("dense", "moe")


def check_mesh(cfg: ArchConfig, ctx: ShardingCtx) -> None:
    """Raise for a family that does not run across a live mesh yet, and
    (``ValueError``) for head counts its ``model`` axis does not split:
    a leaf's columns may divide where its heads do not."""
    if not ctx.live:
        return
    if cfg.family not in MESH_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} across a mesh is the next "
            f"mesh slice (mamba2, jamba and the encoder families); this one "
            f"runs {MESH_FAMILIES}")
    tp = ctx.axis_size("tp")
    for leaf, what, n in (("wq", "heads", cfg.n_heads),
                          ("wk", "KV heads", cfg.n_kv_heads)):
        if n % tp:
            raise ValueError(f"{cfg.name}: layers/*/attn/{leaf}: {n} {what} "
                             f"do not split over mesh axis 'model' of {tp} "
                             f"ranks")


def _param(t: torch.Tensor, trainable: bool) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=trainable)


PARTS = ("attn", "ssm", "cross", "ffn", "moe")


def _maybe_remat(remat: bool, fn, *args):
    """``fn(*args)``, recomputed in the backward pass (nothing it computes
    is kept but its output) when ``remat`` and grad is enabled."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


class Block(nn.Module):
    """One layer's parameters in the reference's names and layout: the
    mixer ``attn`` or ``ssm``, the ``cross`` attention of a cross layer,
    and the FFN ``ffn`` (dense), ``moe`` or none (an SSM layer of a
    pure-SSM or hybrid stack); the parts a layer lacks are None."""

    def __init__(self, parts: Dict[str, Dict[str, torch.Tensor]],
                 trainable: bool = False, specs=None):
        super().__init__()
        self.mixer = "attn" if "attn" in parts else "ssm"
        for name in PARTS:
            leaves = parts.get(name)
            setattr(self, name, None if leaves is None else nn.ParameterDict(
                {k: _param(v, trainable) for k, v in leaves.items()}))
        # part -> leaf -> the dim its spec splits over "fsdp"
        self.fsdp_dims = {part: {k: s.axes.index("fsdp")
                                 for k, s in leaves.items()
                                 if "fsdp" in s.axes}
                          for part, leaves in (specs or {}).items()}

    def weights(self, part: str, ctx: Optional[ShardingCtx]):
        """The leaves of ``part`` with each ``fsdp`` dim whole: all-gathered
        over ``data`` on a live mesh (ZeRO-3), the parameters themselves
        where that axis has one rank."""
        leaves = getattr(self, part)
        if ctx is None or not ctx.live or ctx.axis_size("fsdp") == 1:
            return leaves
        dims = self.fsdp_dims[part]
        return {k: C.all_gather(v, "fsdp", dims[k], ctx) if k in dims else v
                for k, v in leaves.items()}

    def ffn_apply(self, x: torch.Tensor, cfg: ArchConfig,
                  ctx: Optional[ShardingCtx] = None) -> torch.Tensor:
        """The residual stream after this layer's FFN, whatever its kind.
        The MoE gathers its own weights (:func:`moe._moe_sharded`)."""
        if self.ffn is not None:
            return x + L.ffn_apply(self.weights("ffn", ctx), x, cfg, ctx=ctx)
        if self.moe is not None:
            return x + MOE.moe_apply(self.moe, x, cfg, ctx)
        return x


def _check_parts(blk: Block, specs, where: str) -> None:
    parts = {p for p in PARTS if getattr(blk, p) is not None}
    if parts != set(specs):
        raise ValueError(f"{where} holds {parts}, not {set(specs)}")


def _nll_sum(h: torch.Tensor, labels: torch.Tensor,
             w: torch.Tensor) -> torch.Tensor:
    """Summed next-token cross-entropy of one chunk: h [B,cq,D] final-normed
    rows, labels [B,cq], w [D,Vp]. The product in the model dtype, then
    the f32 log-sum-exp over the padded vocabulary, less the label's
    logit."""
    logits = (h @ w).float()
    picked = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - picked).sum()


def _nll_sum_vocab_parallel(h: torch.Tensor, labels: torch.Tensor,
                            w: torch.Tensor, ctx: ShardingCtx
                            ) -> torch.Tensor:
    """:func:`_nll_sum` with w [D, Vp/tp] this rank's columns of the head:
    the local logits [B,cq,Vp/tp] in f32, the row max over ``model``
    (detached), the sum of exponentials over ``model``, and the label's
    logit from the rank that holds it, summed over ``model``. The
    ``[B, cq, Vp]`` logits are never gathered."""
    logits = (h @ w).float()
    n = logits.shape[-1]
    top = C.all_reduce_max(logits.amax(-1), "tp", ctx)
    sumexp = C.all_reduce_sum(torch.exp(logits - top[..., None]).sum(-1),
                              "tp", ctx)
    ids = labels.long() - ctx.index("tp") * n
    inside = (ids >= 0) & (ids < n)
    picked = logits.gather(-1, ids.clamp(0, n - 1)[..., None])[..., 0]
    picked = C.all_reduce_sum(torch.where(inside, picked, 0.0), "tp", ctx)
    return (top + torch.log(sumexp) - picked).sum()


class Model(nn.Module):
    """A model bound to one ``ArchConfig`` and holding its weights
    (frozen unless ``trainable``: a serving model's parameters require no
    gradient): a dense or MoE
    self-attention stack, an attention-free Mamba2 stack, a hybrid, an
    encoder-decoder (``encoder_layers`` and ``encoder_ln`` beside the
    decoder) or a decoder with cross-attention layers.

    The serving methods take and update in place the arena planes
    ``k_pages``/``v_pages`` ``[n_attn_layers, n_rows, page, Hkv, hd]`` and
    the state cache of :meth:`state_cache`.
    """

    def __init__(self, cfg: ArchConfig, params: Dict[str, Any],
                 trainable: bool = False, mesh=None):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"{cfg.name}: the port serves the {FAMILIES} families, not "
                f"family {cfg.family!r}")
        # the sharding context: the dry run's mesh as data, or the live
        # mesh whose blocks ``params`` hold (build_model's ``mesh``)
        self.ctx = ShardingCtx(mesh)
        check_mesh(cfg, self.ctx)
        self.cfg = cfg
        self.vocab_padded = pad_vocab(cfg.vocab, 256)
        self.embedding = _param(params["embed"], trainable)
        self.final_ln = _param(params["final_ln"], trainable)
        self.lm_head = (None if cfg.tie_embeddings
                        else _param(params["lm_head"], trainable))
        self.layers = nn.ModuleList(
            Block(lp, trainable, layer_specs(cfg, i))
            for i, lp in enumerate(params["layers"]))
        if len(self.layers) != cfg.n_layers:
            raise ValueError(f"{len(self.layers)} layers of parameters for "
                             f"a {cfg.n_layers}-layer config")
        for i, blk in enumerate(self.layers):
            _check_parts(blk, layer_specs(cfg, i), f"layer {i} of {cfg.name}")
        self.encoder_layers = self.encoder_ln = None
        if cfg.encoder is not None:
            enc = params["encoder"]
            self.encoder_layers = nn.ModuleList(
                Block(lp, trainable) for lp in enc["layers"])
            if len(self.encoder_layers) != cfg.encoder.n_layers:
                raise ValueError(f"{len(self.encoder_layers)} encoder layers "
                                 f"of parameters for a "
                                 f"{cfg.encoder.n_layers}-layer encoder")
            for i, blk in enumerate(self.encoder_layers):
                _check_parts(blk, encoder_layer_specs(cfg),
                             f"encoder layer {i} of {cfg.name}")
            self.encoder_ln = _param(enc["ln"], trainable)
        self.n_ssm_layers = sum(b.mixer == "ssm" for b in self.layers)
        self.kv_layer = self._kv_layout()
        # layer index -> entry of the state cache's cross K/V
        cross = [i for i, b in enumerate(self.layers) if b.cross is not None]
        self.cross_layer = {i: j for j, i in enumerate(cross)}
        # KV heads this rank holds
        self.n_kv_local = cfg.n_kv_heads // self.ctx.axis_size("tp")

    def _kv_layout(self) -> Dict[int, int]:
        """Layer index -> arena layer of each attention layer, in the
        reference's stacked order: attention slot ``a`` (among the period's
        attention slots), group ``g`` at ``a * n_groups + g``."""
        period = self.cfg.layer_pattern_period
        n_groups = self.cfg.n_layers // period
        slots = [s for s in range(period) if self.cfg.is_attn_layer(s)]
        return {i: slots.index(i % period) * n_groups + i // period
                for i, blk in enumerate(self.layers) if blk.mixer == "attn"}

    @property
    def device(self) -> torch.device:
        return self.embedding.device

    def _tree(self, leaf) -> Dict[str, Any]:
        """``leaf(parameter)`` of every parameter, in the constructor's
        layout."""
        tree: Dict[str, Any] = {
            "embed": leaf(self.embedding), "final_ln": leaf(self.final_ln),
            "layers": [{part: {k: leaf(p) for k, p in getattr(blk, part)
                               .items()}
                        for part in PARTS
                        if getattr(blk, part) is not None}
                       for blk in self.layers]}
        if self.lm_head is not None:
            tree["lm_head"] = leaf(self.lm_head)
        if self.encoder_layers is not None:
            tree["encoder"] = {
                "layers": [{part: {k: leaf(p) for k, p in getattr(blk, part)
                                   .items()}
                            for part in ("attn", "ffn")}
                           for blk in self.encoder_layers],
                "ln": leaf(self.encoder_ln)}
        return tree

    def param_tree(self) -> Dict[str, Any]:
        """The weights in the layout the constructor takes (``init_params``'
        tree), as the parameters' own tensors: no copy."""
        return self._tree(lambda p: p.data)

    # ------------------------------------------------ parameter definitions
    def param_defs(self) -> Dict[str, Any]:
        """The :class:`~repro_torch.models.common.Spec` of every parameter
        in :meth:`param_tree`'s layout (shape, init, dtype, logical
        axes)."""
        return param_specs(self.cfg)

    def abstract_params(self, dtype_override=None) -> Dict[str, Any]:
        """:meth:`param_defs` as ``meta`` tensors: nothing allocated."""
        return abstract_tree(self.param_defs(), dtype_override)

    def param_pspecs(self) -> Dict[str, Any]:
        """Each parameter's partition spec under the model's mesh (all
        None without one)."""
        return param_shardings(self.ctx.mesh, self.param_defs())

    def grad_tree(self) -> Dict[str, Any]:
        """Each parameter's gradient in :meth:`param_tree`'s layout (zeros,
        in the parameter's dtype, where the last backward left none): on a
        live mesh this rank's blocks, once :meth:`sum_grads_over_data` has
        run."""
        return self._tree(lambda p: torch.zeros_like(p) if p.grad is None
                          else p.grad)

    def placements(self) -> Dict[str, Any]:
        """Each parameter's :class:`~repro_torch.distributed.sharding.
        Placement` on the model's mesh: the mesh axes that split it and
        those it is replicated over."""
        return placements(self.param_pspecs(), self.ctx.mesh)

    def sum_grads_over_data(self) -> None:
        """After a backward on a live mesh with a data axis: sum over
        ``data`` the gradients of the leaves that no ``fsdp`` dim splits
        (each data rank saw its own rows), in one all-reduce per dtype.
        The ZeRO-3 leaves' gradients came back from their gathers
        reduce-scattered and are left as they are."""
        if not self.ctx.live or self.ctx.axis_size("batch") == 1:
            return
        params = [p for p, pl in zip(leaves(self._tree(lambda p: p)),
                                     leaves(self.placements()))
                  if "data" in pl.replicated]
        for dt in dict.fromkeys(p.dtype for p in params):
            group = [p for p in params if p.dtype == dt]
            flat = torch.cat([torch.zeros(p.numel(), dtype=dt,
                                          device=p.device) if p.grad is None
                              else p.grad.reshape(-1) for p in group])
            flat = C.all_reduce_sum(flat, "batch", self.ctx)
            for p, g in zip(group, flat.split([p.numel() for p in group])):
                p.grad = g.view_as(p)

    def _one_card(self, what: str) -> None:
        if self.ctx.live:
            raise NotImplementedError(
                f"{self.cfg.name}: {what} runs on one card; across the mesh "
                f"the port runs prefill, the dense-cache decode step and "
                f"training")

    # -------------------------------------------------------------- embedding
    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B,S] -> rows [B,S,D]. On a live mesh vocab-parallel: the
        rank's rows of the table (D gathered over ``data``), a masked
        lookup of the ids they hold, summed over ``model``."""
        ctx = self.ctx
        if not ctx.live:
            return self.embedding[tokens.long()]
        table = C.all_gather(self.embedding, "fsdp", 1, ctx)     # [Vp/tp, D]
        n = table.shape[0]
        ids = tokens.long() - ctx.index("tp") * n
        inside = (ids >= 0) & (ids < n)
        x = torch.where(inside[..., None], table[ids.clamp(0, n - 1)], 0)
        return C.all_reduce_sum(x, "tp", ctx)

    def unembed_weight(self) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return self.embedding.T
        return self.lm_head

    def _logits(self, last: torch.Tensor) -> torch.Tensor:
        """[B, D] final-normed rows -> [B, Vp] f32 logits: the product in the
        model dtype, then the upcast (the reference's cast point). On a
        live mesh column-parallel: the rank's columns (D gathered over
        ``data``), then all-gathered over ``model``."""
        w = self.unembed_weight()
        if not self.ctx.live:
            return (last @ w).float()
        w = C.all_gather(w, "fsdp", 0, self.ctx)                 # [D, Vp/tp]
        last = C.enter(last, "tp", self.ctx)
        return C.all_gather((last @ w).float(), "tp", -1, self.ctx,
                            grad="block")

    # ---------------------------------------------------------------- encoder
    def _encoder_layer(self, blk: Block, x: torch.Tensor,
                       pos: torch.Tensor) -> torch.Tensor:
        o, _, _ = L.attn_full(blk.attn, x, self.cfg, pos, causal=False)
        x = x + o
        return x + L.ffn_apply(blk.ffn, x, self.cfg, gelu=True)

    def encode(self, frames: torch.Tensor,
               remat: bool = False) -> torch.Tensor:
        """Whisper-style encoder over precomputed frame embeddings [B,F,D]:
        non-causal self-attention roped at ``arange(F)`` (rope stands in
        for Whisper's learned positions, as in the reference) and the GELU
        FFN in every layer, then the final norm. With ``remat`` (and grad
        enabled) each layer is recomputed in the backward pass, as the
        reference's ``jax.checkpoint(body)`` does. -> [B,F,D]."""
        pos = torch.arange(frames.shape[1], device=frames.device)[None]
        x = frames
        for blk in self.encoder_layers:
            x = _maybe_remat(remat, self._encoder_layer, blk, x, pos)
        return rms_norm(x, self.encoder_ln, self.cfg.norm_eps)

    def _cross_src(self, extras, remat: bool = False
                   ) -> Optional[torch.Tensor]:
        """What the cross-attention layers read: the encoder's output over
        ``extras["frames"]`` (encdec) or ``extras["ctx_embeds"]`` (vlm);
        None for a model without cross-attention."""
        if not self.cross_layer:
            return None
        key = self.cfg.ctx_key
        if not extras or key not in extras:
            raise ValueError(f"{self.cfg.name}: prefill needs "
                             f"extras[{key!r}]")
        if self.encoder_layers is not None:
            return self.encode(extras[key], remat)
        return extras[key]

    # ---------------------------------------------------------------- training
    def _layer(self, blk: Block, x: torch.Tensor, positions: torch.Tensor,
               src: Optional[torch.Tensor]) -> torch.Tensor:
        """One decoder layer over the whole sequence: the mixer (causal
        self-attention or the Mamba2 scan), the cross sub-layer of a cross
        layer, the FFN. On a live mesh the attention's and the FFN's
        weights are gathered over ``data`` here, inside the layer's
        recomputation, so the backward gathers them again rather than
        keeping them."""
        cfg, ctx = self.cfg, self.ctx
        if blk.mixer == "attn":
            o, _, _ = L.attn_full(blk.weights("attn", ctx), x, cfg,
                                  positions, ctx=ctx)
        else:
            o, _ = M2.ssm_full(blk.ssm, x, cfg)
        x = x + o
        if blk.cross is not None:
            o, _, _ = L.attn_full(blk.cross, x, cfg, positions, kv_src=src,
                                  causal=False)
            x = x + o
        return blk.ffn_apply(x, cfg, ctx)

    def backbone(self, tokens: torch.Tensor, extras=None,
                 remat: bool = True) -> torch.Tensor:
        """tokens [B,S] -> the final-normed hidden rows [B,S,D] (on a live
        mesh: this rank's rows, whole over ``model``). With ``remat`` (and
        grad enabled) every layer, and every encoder layer, is recomputed
        in the backward pass (``torch.utils.checkpoint``), so only each
        layer's input is kept."""
        x = self.embed(tokens)
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
        src = self._cross_src(extras, remat)
        for blk in self.layers:
            x = _maybe_remat(remat, self._layer, blk, x, positions, src)
        return rms_norm(x, self.final_ln, self.cfg.norm_eps)

    def loss(self, tokens: torch.Tensor, labels: torch.Tensor,
             extras=None, global_rows: Optional[int] = None
             ) -> torch.Tensor:
        """Mean next-token cross-entropy (f32 scalar) of tokens [B,S]
        against labels [B,S], over the padded vocabulary as the reference's
        ``Model.loss``: the sequence in chunks of the largest divisor of S
        <= 512, each chunk's ``[B, cq, Vp]`` logits recomputed in the
        backward pass, the chunks' sums added in order.

        On a live mesh ``tokens`` are this rank's rows of a batch of
        ``global_rows`` (default: B times the data axis, the rows split
        over ``data``), the loss is vocab-parallel
        (:func:`_nll_sum_vocab_parallel`; the head's columns gathered over
        ``data`` once, the rows entering them once) and the result is this
        rank's share of the batch's mean: the shares of the data ranks sum
        to it. Where the data axis does not divide the batch, every data
        rank holds all of it (``global_rows`` == B) and its share is the
        mean over the data axis's size, so that neither the loss nor the
        gradients summed over ``data`` count the batch more than once."""
        hidden = self.backbone(tokens, extras)
        ctx = self.ctx
        w = self.unembed_weight()
        B, S, _ = hidden.shape
        share = 1
        if ctx.live:
            dp = ctx.axis_size("batch")
            rows = B * dp if global_rows is None else global_rows
            if rows == B:
                share = dp
            elif rows != B * dp:
                raise ValueError(f"{B} rows on a rank of a data axis of {dp} "
                                 f"ranks: not a block of a batch of {rows}")
            w = C.all_gather(w, "fsdp", 0, ctx)
            hidden = C.enter(hidden, "tp", ctx)
        else:
            rows = B
        nll = (_nll_sum if ctx.axis_size("tp") == 1 else
               lambda h, lab, w: _nll_sum_vocab_parallel(h, lab, w, ctx))
        cq = min(512, S)
        while S % cq:
            cq -= 1
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for c0 in range(0, S, cq):
            total = total + _maybe_remat(True, nll, hidden[:, c0:c0 + cq],
                                         labels[:, c0:c0 + cq], w)
        return total / (rows * S) / share

    # ---------------------------------------------------------------- prefill
    def prefill(self, tokens: torch.Tensor, extras=None) -> Tuple[
            torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
        """tokens [B,P] -> (last-token logits [B,Vp] f32, k, v
        [n_attn_layers, B, P, Hkv, hd]: the prompt's K/V, layer-stacked;
        None for a model without attention layers). ``extras`` as for
        :meth:`prefill_with_state`."""
        logits, k, v, _ = self.prefill_with_state(tokens, extras)
        return logits, k, v

    def prefill_with_state(self, tokens: torch.Tensor, extras=None):
        """:meth:`prefill`, plus the decode cache the arena does not hold,
        in :meth:`state_cache`'s layout for the ``B`` lanes: the SSM
        layers' ``"state"`` [n_ssm_layers, B, H, N, P] f32 and ``"conv"``
        [n_ssm_layers, B, conv_dim-1, di], and the cross layers'
        ``"cross_k"``/``"cross_v"`` [n_cross_layers, B, n_ctx, Hkv, hd]; None
        for a model with neither. The K/V stack is in arena-layer order.

        ``extras``: ``{"frames": [B,F,D]}`` for an encdec model (the
        encoder runs over them), ``{"ctx_embeds": [B,N,C]}`` for a vlm;
        each cross layer attends to them after its mixer, before its
        FFN."""
        cfg, ctx = self.cfg, self.ctx
        x = self.embed(tokens)
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
        src = self._cross_src(extras)
        n_kv = len(self.kv_layer)
        ks, vs = [None] * n_kv, [None] * n_kv
        parts = {"state": [], "conv": [], "cross_k": [], "cross_v": []}
        for i, blk in enumerate(self.layers):
            if blk.mixer == "attn":
                o, k, v = L.attn_full(blk.weights("attn", ctx), x, cfg,
                                      positions, ctx=ctx)
                ks[self.kv_layer[i]], vs[self.kv_layer[i]] = k, v
            else:
                o, c = M2.ssm_full(blk.ssm, x, cfg)
                parts["state"].append(c["state"])
                parts["conv"].append(c["conv"])
            x = x + o
            if blk.cross is not None:
                o, ck, cv = L.attn_full(blk.cross, x, cfg, positions,
                                        kv_src=src, causal=False)
                x = x + o
                parts["cross_k"].append(ck)
                parts["cross_v"].append(cv)
            x = blk.ffn_apply(x, cfg, ctx)
        x = rms_norm(x, self.final_ln, cfg.norm_eps)
        kv = (torch.stack(ks), torch.stack(vs)) if ks else (None, None)
        state = {name: torch.stack(ts) for name, ts in parts.items() if ts}
        return (self._logits(x[:, -1]), *kv, state or None)

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
        rows/offs [B,C] the chunk's write coordinates, distinct wherever a
        row reads them (a scatter on the card lands duplicates in any
        order: ``Engine`` sends the pad columns' to an unread slot but
        one); last_idx [B] the in-chunk index of each sequence's last real
        token. ``attend`` is the chunk attention
        (``kernels.ops.chunk_prefill_attention``).
        Returns the last-token logits [B,Vp] f32."""
        self._one_card("chunked prefill")
        self._require_paged("chunked prefill")
        cfg = self.cfg
        x = self.embed(tokens)
        for i, blk in enumerate(self.layers):
            x = x + L.attn_chunk_paged(blk.attn, x, cfg, positions, k_pages,
                                       v_pages, self.kv_layer[i],
                                       block_tables, rows, offs, attend)
            x = blk.ffn_apply(x, cfg)
        x = rms_norm(x, self.final_ln, cfg.norm_eps)
        lanes = torch.arange(tokens.shape[0], device=x.device)
        return self._logits(x[lanes, last_idx.long()])

    def prefill_suffix(self, k_pages, v_pages, tokens, start: int,
                       block_table, attend) -> torch.Tensor:
        """Prefill only the unmatched suffix of one prompt whose first
        ``start`` tokens' K/V already sit in the sequence's pages (a
        prefix-cache hit): the reference's ``Model.prefill_suffix``, run as
        one paged chunk of the sequence itself. tokens [1,S] the suffix at
        positions ``start .. start+S-1``; block_table [1,W] int32 the
        sequence's row table, whose pages from ``start`` on are private to
        it. The suffix's K/V is written into those pages (where the
        reference returns it for the caller to scatter) before ``attend``
        (``kernels.ops.chunk_prefill_attention``) reads prefix and suffix
        through the table. Returns the last token's logits [1,Vp] f32."""
        S = tokens.shape[1]
        page = k_pages.shape[2]
        dev = tokens.device
        pos = torch.arange(start, start + S, dtype=torch.int32,
                           device=dev)[None]
        rows = block_table[0].long()[(pos // page).long()].int()
        return self.prefill_chunk(
            k_pages, v_pages, tokens, pos, block_table, rows, pos % page,
            torch.full((1,), S - 1, dtype=torch.int32, device=dev), attend)

    # ------------------------------------------------------- paged serving
    @property
    def supports_prefix_reuse(self) -> bool:
        """Only a pure causal self-attention stack (dense or MoE) can resume
        a prompt from cached pages: SSM state is positionally recurrent, so
        a hybrid cannot, and a cross-attention model's context lives in
        its state cache, not in pages."""
        return self.n_ssm_layers == 0 and not self.cross_layer

    @property
    def supports_chunked_prefill(self) -> bool:
        """Chunked prefill needs the whole prompt context in paged
        self-attention KV: the prefix-reuse rule."""
        return self.supports_prefix_reuse

    @property
    def supports_decode_horizon(self) -> bool:
        """The horizon loop carries only pages and positions between
        iterations: the prefix-reuse rule (SSM and hybrid models decode one
        token at a time)."""
        return self.supports_prefix_reuse

    def paged_kv_layout(self) -> Tuple[int, int, int, torch.dtype]:
        """Self-attention KV geometry for the serving arena:
        ``(n_layers, Hkv, hd, dtype)``; layer ``i`` writes plane layer
        ``kv_layer[i]``. ``n_layers == 0`` means nothing to page (a pure-SSM
        model holds recurrent state only)."""
        cfg = self.cfg
        return (cfg.n_layers - self.n_ssm_layers, cfg.n_kv_heads,
                cfg.head_dim_, cfg.dtype)

    def decode_step_paged(self, k_pages, v_pages, block_tables, seq_lens,
                          rows, offs, tokens, positions, attend,
                          inline: bool = False,
                          state_cache: Optional[Dict[str, torch.Tensor]]
                          = None) -> torch.Tensor:
        """One token for every sequence through the paged arena.
        tokens [B,1]; positions [B] the new token's position; seq_lens [B]
        int32 (positions + 1, 1 for idle lanes); rows/offs [B] its write
        coordinate. ``attend`` is the paged attention
        (``kernels.ops.paged_attention``). A hybrid's SSM layers step
        ``state_cache`` (:meth:`state_cache`) in place, every lane, idle
        ones too, as the reference's do; a cross layer reads its lane's
        static cross K/V there (:func:`layers.attn_decode_cross`).
        Returns logits [B,Vp] f32."""
        self._one_card("paged decode")
        if not self.kv_layer:
            raise NotImplementedError(
                f"{self.cfg.name}: no attention layer to page "
                f"(decode_step decodes from the state cache)")
        cfg = self.cfg
        x = self.embed(tokens)
        j = 0
        for i, blk in enumerate(self.layers):
            if blk.mixer == "attn":
                x = x + L.attn_decode_paged(
                    blk.attn, x, cfg, positions, k_pages, v_pages,
                    self.kv_layer[i], block_tables, seq_lens, rows, offs,
                    attend, inline=inline)
            else:
                x = x + M2.ssm_decode(blk.ssm, x, state_cache["state"][j],
                                      state_cache["conv"][j], cfg)
                j += 1
            if blk.cross is not None:
                c = self.cross_layer[i]
                x = x + L.attn_decode_cross(blk.cross, x, cfg,
                                            state_cache["cross_k"][c],
                                            state_cache["cross_v"][c])
            x = blk.ffn_apply(x, cfg)
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
        self._one_card("the decode horizon")
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
        """A zeroed decode cache of ``batch`` lanes for what the arena does
        not hold (the reference's ``state_cache_specs`` minus the stacking
        by group): the SSM layers' ``{"state": [n_ssm_layers, batch, H, N,
        P] f32, "conv": [n_ssm_layers, batch, conv_dim-1, di]}`` and the
        cross layers' static ``{"cross_k", "cross_v": [n_cross_layers,
        batch, n_ctx, Hkv, hd]}`` in the model dtype; ``{}`` for a model
        with neither."""
        cfg, dev = self.cfg, self.device
        out: Dict[str, torch.Tensor] = {}
        if self.n_ssm_layers:
            s, D, n = cfg.ssm, cfg.d_model, self.n_ssm_layers
            out["state"] = torch.zeros(
                (n, batch, s.n_heads(D), s.d_state, s.head_dim),
                dtype=torch.float32, device=dev)
            out["conv"] = torch.zeros(
                (n, batch, s.conv_dim - 1, s.d_inner(D)), dtype=cfg.dtype,
                device=dev)
        if self.cross_layer:
            shape = (len(self.cross_layer), batch, cfg.n_ctx,
                     cfg.n_kv_heads, cfg.head_dim_)
            out["cross_k"] = torch.zeros(shape, dtype=cfg.dtype, device=dev)
            out["cross_v"] = torch.zeros(shape, dtype=cfg.dtype, device=dev)
        return out

    def cache(self, batch: int, s_max: int,
              page_tokens: int = 16) -> Dict[str, torch.Tensor]:
        """The whole dense decode cache of ``batch`` lanes (the reference's
        ``cache_specs``, unstacked): :meth:`state_cache` plus, for a model
        with attention layers, ``{"k", "v": [n_attn_layers, batch, S, Hkv,
        hd]}`` in the model dtype, S = ``s_max`` rounded up to a multiple of
        ``page_tokens`` so that :meth:`decode_step` can read a lane's cache
        as whole pages. Layer ``i`` uses entry ``kv_layer[i]``. On a live
        mesh ``batch`` is the rank's lanes and Hkv its ``Hkv / tp`` heads:
        the cache is split by KV heads over ``model``, where the reference's
        ``cache_specs`` split its sequence (``kv_sp``)."""
        out = self.state_cache(batch)
        if self.kv_layer:
            cfg = self.cfg
            S = -(-s_max // page_tokens) * page_tokens
            shape = (len(self.kv_layer), batch, S, self.n_kv_local,
                     cfg.head_dim_)
            out["k"] = torch.zeros(shape, dtype=cfg.dtype, device=self.device)
            out["v"] = torch.zeros(shape, dtype=cfg.dtype, device=self.device)
        return out

    def cache_specs(self, batch: int, seq: int, page_tokens: int = 16):
        """(shape/dtype tree, partition-spec tree) of :meth:`cache`'s
        entries for ``batch`` lanes of ``seq`` tokens: nothing allocated.
        Each entry stacks its layers on a leading dim that no mesh axis
        splits; the rest is split as the reference's ``cache_specs``
        splits a slot's cache (lanes over the batch axes, K/V rows over
        ``kv_sp``, SSM heads and conv channels over ``tp``)."""
        cfg, ctx = self.cfg, self.ctx
        raw = {}
        n_kv, n_ssm, n_cross = (len(self.kv_layer), self.n_ssm_layers,
                                len(self.cross_layer))
        if n_ssm:
            s, D = cfg.ssm, cfg.d_model
            raw["state"] = ((n_ssm, batch, s.n_heads(D), s.d_state,
                             s.head_dim), torch.float32,
                            ("batch", "tp", None, None))
            raw["conv"] = ((n_ssm, batch, s.conv_dim - 1, s.d_inner(D)),
                           cfg.dtype, ("batch", None, "tp"))
        if n_cross:
            for name in ("cross_k", "cross_v"):
                raw[name] = ((n_cross, batch, cfg.n_ctx, cfg.n_kv_heads,
                              cfg.head_dim_), cfg.dtype,
                             ("batch", "kv_sp", None, None))
        if n_kv:
            S = -(-seq // page_tokens) * page_tokens
            for name in ("k", "v"):
                raw[name] = ((n_kv, batch, S, cfg.n_kv_heads, cfg.head_dim_),
                             cfg.dtype, ("batch", "kv_sp", None, None))
        structs = {k: TensorSpec(shp, dt) for k, (shp, dt, _) in raw.items()}
        specs = {k: (None,) + ctx.spec(*axes, dims=shp[1:])
                 for k, (shp, _, axes) in raw.items()}
        return structs, specs

    def decode_step(self, cache: Dict[str, torch.Tensor],
                    tokens: torch.Tensor, positions: torch.Tensor,
                    page_tokens: int = 16) -> torch.Tensor:
        """One token for every lane from the dense decode cache
        (:meth:`cache`, updated in place; :meth:`state_cache` alone for a
        pure-SSM model): the reference's ``decode_step``. tokens [B,1];
        positions [B] the new token's index. An attention layer writes the
        token's K/V into its lane's dense cache and reads it back as pages
        of ``page_tokens`` through ``kernels.ops.paged_attention``; SSM
        layers step their state, cross layers read their static K/V, every
        lane, idle ones too, as the reference's do. Returns logits [B,Vp]
        f32. On a live mesh: the rank's lanes, and :meth:`cache`'s blocks."""
        cfg, ctx = self.cfg, self.ctx
        x = self.embed(tokens)
        if self.kv_layer:
            bt, seq_lens = L.dense_table(tokens.shape[0], cache["k"].shape[2],
                                         page_tokens, positions)
        j = 0
        for i, blk in enumerate(self.layers):
            if blk.mixer == "attn":
                a = self.kv_layer[i]
                x = x + L.attn_decode(blk.weights("attn", ctx), x, cfg,
                                      positions, cache["k"][a], cache["v"][a],
                                      bt, seq_lens, page_tokens,
                                      ops.paged_attention, ctx=ctx)
            else:
                x = x + M2.ssm_decode(blk.ssm, x, cache["state"][j],
                                      cache["conv"][j], cfg)
                j += 1
            if blk.cross is not None:
                c = self.cross_layer[i]
                x = x + L.attn_decode_cross(blk.cross, x, cfg,
                                            cache["cross_k"][c],
                                            cache["cross_v"][c])
            x = blk.ffn_apply(x, cfg, ctx)
        x = rms_norm(x, self.final_ln, cfg.norm_eps)
        return self._logits(x[:, 0])
