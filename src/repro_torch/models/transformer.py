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

Across a live mesh (``build_model(..., mesh=make_local_mesh(d, m))``,
every family): each rank holds its block of every leaf, the encoder's too
(:meth:`ShardingCtx.shard_tree` under :meth:`Model.param_pspecs`), the
attention's by whole heads
(:func:`~repro_torch.distributed.sharding.head_layout`): where ``model``
exceeds the KV heads, each KV head is replicated over the ranks whose
query heads read it, their gradients summed over those ranks, and a
group's query heads that do not split evenly over them give the first
ranks one more.
:meth:`Model.prefill`, :meth:`Model.prefill_with_state` and
:meth:`Model.decode_step` then run Megatron tensor parallelism over
``model`` (the attention's, the cross-attention's and the encoder's
heads, the SSM's heads and ``d_inner`` channels, ``d_ff`` and the
vocabulary split; the ``wo``, ``wout`` and ``w_down`` products
all-reduced, and the SSM's gated norm's sum of squares), ZeRO-3 over
``data`` (each leaf's ``fsdp`` dim all-gathered before its layer uses it)
and the reference's expert parallelism
(:func:`repro_torch.models.moe._moe_sharded`), on the rank's rows of the
batch (and of the frames or patch embeddings); activations, the
encoder's output among them, are whole over ``model`` between the
layers. The decode cache holds the rank's lanes and heads
(:meth:`Model.cache`). :meth:`Model.backbone` and :meth:`Model.loss`
train the same way: the collectives carry the gradients back
(:mod:`repro_torch.distributed.collectives`; each ZeRO-3 gather is
recomputed in the backward with its layer and reduce-scatters the
weight's gradient to this rank's block), and the loss is vocab-parallel.
The paged, chunked and horizon methods run on one card and raise on a
live mesh.

That is the reference's default distribution mode, ``tp_sp``.
``build_model(..., mode=)`` takes its two others
(:mod:`repro_torch.distributed.sharding`) for the dense and MoE families:
``tp_sp_opt`` (a sequence-parallel prefill and backbone,
:meth:`Model._layer_seq_split`) and ``fsdp_cp`` (a context-parallel
prefill and backbone; a weight-stationary decode step,
:meth:`Model._decode_stationary`, over a cache split by sequence). In
both the residual holds the rank's rows of the sequence, so a norm scale
meets those rows alone and its gradient is summed over ``model`` after
the backward (:meth:`Model.sum_norm_grads_over_model`). The other
families raise ``NotImplementedError`` in these modes
(``MODE_FAMILIES``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import import_dynamo
from repro_torch.configs.base import ArchConfig, TensorSpec
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import (ShardingCtx, head_layout,
                                              param_shardings, placements)
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
MESH_FAMILIES = FAMILIES


# the families each sharding mode runs (the others raise)
MODE_FAMILIES = {"tp_sp": FAMILIES, "tp_sp_opt": ("dense", "moe"),
                 "fsdp_cp": ("dense", "moe")}


def sharding_ctx(cfg: ArchConfig, mesh, mode: str = "tp_sp") -> ShardingCtx:
    """The model's sharding context on ``mesh`` in ``mode``, given the
    config's heads, so that a live mesh cuts the attention's leaves by the
    head layout (``fsdp_cp``, whose heads are not split, cuts the specs'
    equal blocks); raises where :func:`check_mesh` does."""
    ctx = ShardingCtx(mesh, mode=mode)
    check_mesh(cfg, ctx)
    if cfg.family == "ssm" or mode == "fsdp_cp":
        return ctx
    return ShardingCtx(mesh, heads=(cfg.n_heads, cfg.n_kv_heads), mode=mode)


def check_mesh(cfg: ArchConfig, ctx: ShardingCtx) -> None:
    """Raise ``ValueError``, naming the leaf, for heads that a live mesh's
    ``model`` axis cannot lay out (:func:`~repro_torch.distributed.
    sharding.head_layout`: the attention's, the cross layers' and the
    encoder's alike) or SSM heads and channels it does not split."""
    if not ctx.live:
        return
    tp = ctx.axis_size("tp")
    if cfg.family != "ssm" and ctx.mode != "fsdp_cp":
        try:
            head_layout(cfg.n_heads, cfg.n_kv_heads, tp, 0)
        except ValueError as e:
            raise ValueError(f"{cfg.name}: {e}") from None
    if cfg.ssm is None:
        return
    s = cfg.ssm
    for leaf, what, n in (("layers/*/ssm/wdt", "SSM heads",
                           s.n_heads(cfg.d_model)),
                          ("layers/*/ssm/wx", "d_inner channels",
                           s.d_inner(cfg.d_model))):
        if n % tp:
            raise ValueError(f"{cfg.name}: {leaf}: {n} {what} do not split "
                             f"over mesh axis 'model' of {tp} ranks")
    # a rank's block of the SSM heads holds whole groups or lies in one
    H = s.n_heads(cfg.d_model) // tp
    per = s.n_heads(cfg.d_model) // s.n_groups
    if H % per and per % H:
        raise ValueError(f"{cfg.name}: layers/*/ssm/wB: {s.n_groups} "
                         f"groups of {per} heads do not align with "
                         f"the {H} SSM heads of each of {tp} ranks")


def _param(t: torch.Tensor, trainable: bool) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=trainable)


PARTS = ("attn", "ssm", "cross", "ffn", "moe")


def _maybe_remat(remat: bool, fn, *args):
    """``fn(*args)``, recomputed in the backward pass (nothing it computes
    is kept but its output) when ``remat`` and grad is enabled."""
    if remat and torch.is_grad_enabled():
        import_dynamo()
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
        # part -> leaf -> the dim its spec splits over "fsdp" / "tp"
        self.fsdp_dims, self.tp_dims = (
            {part: {k: s.axes.index(axis) for k, s in leaves.items()
                    if axis in s.axes}
             for part, leaves in (specs or {}).items()}
            for axis in ("fsdp", "tp"))

    def weights(self, part: str, ctx: Optional[ShardingCtx],
                whole: bool = False):
        """The leaves of ``part`` with each ``fsdp`` dim whole: all-gathered
        over ``data`` on a live mesh (ZeRO-3), the parameters themselves
        where that axis has one rank. With ``whole`` (``fsdp_cp``'s
        prefill) each ``tp`` dim is all-gathered over ``model`` as well:
        the whole leaves."""
        leaves = getattr(self, part)
        if ctx is None or not ctx.live:
            return leaves
        out = dict(leaves)
        for axis, dims in (("fsdp", self.fsdp_dims[part]),
                           ("tp", self.tp_dims[part] if whole else {})):
            if ctx.axis_size(axis) > 1:
                out.update({k: C.all_gather(out[k], axis, d, ctx)
                            for k, d in dims.items()})
        return out

    def ffn_apply(self, x: torch.Tensor, cfg: ArchConfig,
                  ctx: Optional[ShardingCtx] = None,
                  sp: bool = False) -> torch.Tensor:
        """The residual stream after this layer's FFN, whatever its kind.
        The MoE gathers its own weights (:func:`moe._moe_sharded`). With
        ``sp`` x holds the rank's rows of the sequence: ``tp_sp_opt``'s
        FFN gathers and reduce-scatters them, ``fsdp_cp``'s runs on them
        with its whole weights and no collective."""
        if self.ffn is not None:
            if sp and ctx.mode == "fsdp_cp":
                return x + L.ffn_apply(self.weights("ffn", ctx, whole=True),
                                       x, cfg)
            return x + L.ffn_apply(self.weights("ffn", ctx), x, cfg, ctx=ctx,
                                   sp=sp)
        if self.moe is not None:
            return x + MOE.moe_apply(self.moe, x, cfg, ctx, sp)
        return x

    def ffn_stationary(self, x: torch.Tensor, cfg: ArchConfig,
                       ctx: ShardingCtx, split: bool) -> torch.Tensor:
        """:meth:`ffn_apply` in ``fsdp_cp``'s weight-stationary decode step:
        x [B, 1, D/dp], the weights in their blocks; ``split`` whether the
        lanes are split over ``data``."""
        if self.ffn is not None:
            return x + L.ffn_decode_stationary(self.ffn, x, cfg, ctx)
        return x + MOE.moe_decode_stationary(self.moe, x, cfg, ctx, split)


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
                 trainable: bool = False, mesh=None, mode: str = "tp_sp"):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"{cfg.name}: the port serves the {FAMILIES} families, not "
                f"family {cfg.family!r}")
        # the sharding context: the dry run's mesh as data, or the live
        # mesh whose blocks ``params`` hold (build_model's ``mesh``)
        self.ctx = sharding_ctx(cfg, mesh, mode)
        if cfg.family not in MODE_FAMILIES[mode]:
            raise NotImplementedError(
                f"{cfg.name}: sharding mode {mode!r} runs the "
                f"{MODE_FAMILIES[mode]} families, not family "
                f"{cfg.family!r} (ROADMAP §1)")
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
                Block(lp, trainable, encoder_layer_specs(cfg))
                for lp in enc["layers"])
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
        # KV heads (and SSM heads) this rank holds: on a live mesh its
        # block of the head layout (one replicated KV head where ``model``
        # exceeds them), else all
        tp = self.ctx.axis_size("tp") if self.ctx.live else 1
        hb = self.ctx.head_block
        self.n_kv_local = (hb.kv[1] - hb.kv[0] if hb is not None
                           else cfg.n_kv_heads if mode == "fsdp_cp"
                           else cfg.n_kv_heads // tp)
        self.n_ssm_heads_local = (cfg.ssm.n_heads(cfg.d_model) // tp
                                  if cfg.ssm is not None else 0)

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
        return placements(self.param_pspecs(), self.ctx.mesh,
                          self.ctx.kv_replicas)

    def sum_grads_over_data(self) -> None:
        """After a backward on a live mesh with a data axis: sum over
        ``data`` the gradients of the leaves that no ``fsdp`` dim splits
        (each data rank saw its own rows), in one all-reduce per dtype.
        The ZeRO-3 leaves' gradients came back from their gathers
        reduce-scattered and are left as they are."""
        if not self.ctx.live or self.ctx.axis_size("batch") == 1:
            return
        self._sum_grads([p for p, pl in zip(leaves(self._tree(lambda p: p)),
                                            leaves(self.placements()))
                         if "data" in pl.replicated], "batch")

    def sum_norm_grads_over_model(self) -> None:
        """After a backward in ``tp_sp_opt`` or ``fsdp_cp`` on a live mesh
        with a model axis: sum over ``model`` the gradients of the RMS-norm
        scales that the residual's rows meet before any collective (each
        layer part's ``ln`` and ``final_ln``), in one all-reduce per dtype.
        The residual holds the rank's rows of the sequence, so each rank's
        gradient of such a scale covers its rows alone. The other leaves
        replicated over ``model`` come back whole: the qk-norm scales and
        the router enter the rank's block through
        :func:`~repro_torch.distributed.collectives.enter`."""
        ctx = self.ctx
        if not ctx.live or ctx.mode == "tp_sp" or ctx.axis_size("tp") == 1:
            return
        self._sum_grads([self.final_ln] + [
            getattr(blk, part)["ln"] for blk in self.layers
            for part in PARTS if getattr(blk, part) is not None], "tp")

    def _sum_grads(self, params, logical: str) -> None:
        """Sum the gradients of ``params`` over ``logical``'s line, one
        all-reduce per dtype (a missing gradient counts as zeros)."""
        for dt in dict.fromkeys(p.dtype for p in params):
            group = [p for p in params if p.dtype == dt]
            flat = torch.cat([torch.zeros(p.numel(), dtype=dt,
                                          device=p.device) if p.grad is None
                              else p.grad.reshape(-1) for p in group])
            flat = C.all_reduce_sum(flat, logical, self.ctx)
            for p, g in zip(group, flat.split([p.numel() for p in group])):
                p.grad = g.view_as(p)

    def _seq_split(self, S: int) -> bool:
        """Whether a prefill of ``S`` rows runs split over ``model`` by
        sequence (``tp_sp_opt`` for S > 1, as the reference applies it;
        ``fsdp_cp``), on a live mesh. Raises ``ValueError`` where
        ``model`` does not divide S."""
        ctx = self.ctx
        split = ctx.live and (ctx.mode == "fsdp_cp"
                              or (ctx.mode == "tp_sp_opt" and S > 1))
        if split and S % ctx.axis_size("tp"):
            raise ValueError(f"{self.cfg.name}: a prompt of {S} rows does "
                             f"not split over mesh axis 'model' of "
                             f"{ctx.axis_size('tp')} ranks (sharding mode "
                             f"{ctx.mode!r})")
        return split

    def _one_card(self, what: str) -> None:
        if self.ctx.live:
            raise NotImplementedError(
                f"{self.cfg.name}: {what} runs on one card; across the mesh "
                f"the port runs prefill, the dense-cache decode step and "
                f"training")

    # -------------------------------------------------------------- embedding
    def embed(self, tokens: torch.Tensor, sp: bool = False,
              stationary: bool = False) -> torch.Tensor:
        """tokens [B,S] -> rows [B,S,D]. On a live mesh vocab-parallel: the
        rank's rows of the table (D gathered over ``data``), a masked
        lookup of the ids they hold, summed over ``model``; with ``sp``
        reduce-scattered over ``model`` to the rank's rows of the sequence
        [B, S/tp, D]. ``stationary`` (``fsdp_cp``'s decode step): the
        table's block [Vp/tp, D/dp] as it is, -> [B, S, D/dp]."""
        ctx = self.ctx
        if not ctx.live:
            return self.embedding[tokens.long()]
        table = (self.embedding if stationary
                 else C.all_gather(self.embedding, "fsdp", 1, ctx))
        n = table.shape[0]
        ids = tokens.long() - ctx.index("tp") * n
        inside = (ids >= 0) & (ids < n)
        x = torch.where(inside[..., None], table[ids.clamp(0, n - 1)], 0)
        if sp:
            return C.reduce_scatter(x, "tp", 1, ctx)
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
        cfg, ctx = self.cfg, self.ctx
        o, _, _ = L.attn_full(blk.weights("attn", ctx), x, cfg, pos,
                              causal=False, ctx=ctx)
        x = x + o
        return x + L.ffn_apply(blk.weights("ffn", ctx), x, cfg, gelu=True,
                               ctx=ctx)

    def encode(self, frames: torch.Tensor,
               remat: bool = False) -> torch.Tensor:
        """Whisper-style encoder over precomputed frame embeddings [B,F,D]:
        non-causal self-attention roped at ``arange(F)`` (rope stands in
        for Whisper's learned positions, as in the reference) and the GELU
        FFN in every layer, then the final norm. With ``remat`` (and grad
        enabled) each layer is recomputed in the backward pass, as the
        reference's ``jax.checkpoint(body)`` does. On a live mesh the
        rank's rows, its heads and block of ``d_ff``, as the decoder's
        layers. -> [B,F,D]."""
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
        layer, the FFN. On a live mesh each part's weights are gathered
        over ``data`` here, inside the layer's recomputation, so the
        backward gathers them again rather than keeping them."""
        cfg, ctx = self.cfg, self.ctx
        if blk.mixer == "attn":
            o, _, _ = L.attn_full(blk.weights("attn", ctx), x, cfg,
                                  positions, ctx=ctx)
        else:
            o, _ = M2.ssm_full(blk.weights("ssm", ctx), x, cfg, ctx)
        x = x + o
        if blk.cross is not None:
            o, _, _ = L.attn_full(blk.weights("cross", ctx), x, cfg,
                                  positions, kv_src=src, causal=False,
                                  ctx=ctx)
            x = x + o
        return blk.ffn_apply(x, cfg, ctx)

    def _attn_seq_split(self, blk: Block, x: torch.Tensor,
                        positions: torch.Tensor):
        """The self-attention of one layer on the rank's rows x [B, S/tp,
        D] of the sequence: ``tp_sp_opt``'s all-gathers the normed rows
        over ``model`` and reduce-scatters its output (the rank's heads;
        ``positions`` the whole sequence's), ``fsdp_cp``'s is context
        parallel on the whole weights (``positions`` the rank's rows). ->
        (output [B, S/tp, D], k, v: the rank's heads over the sequence in
        ``tp_sp_opt``, every head of the rank's rows in ``fsdp_cp``)."""
        cfg, ctx = self.cfg, self.ctx
        if ctx.mode == "fsdp_cp":
            return L.attn_context_parallel(
                blk.weights("attn", ctx, whole=True), x, cfg, positions, ctx)
        return L.attn_full(blk.weights("attn", ctx), x, cfg, positions,
                           ctx=ctx, sp=True)

    def _layer_seq_split(self, blk: Block, x: torch.Tensor,
                         positions: torch.Tensor) -> torch.Tensor:
        """One layer of a dense or MoE stack in ``tp_sp_opt`` or
        ``fsdp_cp`` (:meth:`_attn_seq_split`, then the FFN or MoE on the
        rank's rows): the residual [B, S/tp, D] in and out."""
        o, _, _ = self._attn_seq_split(blk, x, positions)
        return blk.ffn_apply(x + o, self.cfg, self.ctx, sp=True)

    def _positions(self, S: int, split: bool, dev) -> torch.Tensor:
        """[1, n] rope positions of the attention's rows: the rank's
        block of S in ``fsdp_cp``'s split, else all S."""
        if split and self.ctx.mode == "fsdp_cp":
            s = S // self.ctx.axis_size("tp")
            m = self.ctx.index("tp")
            return torch.arange(m * s, (m + 1) * s, device=dev)[None]
        return torch.arange(S, device=dev)[None]

    def backbone(self, tokens: torch.Tensor, extras=None,
                 remat: bool = True) -> torch.Tensor:
        """tokens [B,S] -> the final-normed hidden rows [B,S,D] (on a live
        mesh: this rank's rows, whole over ``model``; in ``tp_sp_opt`` and
        ``fsdp_cp`` its block [B, S/tp, D] of the sequence,
        :meth:`_layer_seq_split`). With ``remat`` (and grad enabled) every
        layer, and every encoder layer, is recomputed in the backward pass
        (``torch.utils.checkpoint``), so only each layer's input is
        kept."""
        S = tokens.shape[1]
        split = self._seq_split(S)
        x = self.embed(tokens, sp=split)
        positions = self._positions(S, split, tokens.device)
        if split:
            layer, args = self._layer_seq_split, (positions,)
        else:
            layer = self._layer
            args = (positions, self._cross_src(extras, remat))
        for blk in self.layers:
            x = _maybe_remat(remat, layer, blk, x, *args)
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
        ``data`` once, the rows entering them once; in ``tp_sp_opt`` and
        ``fsdp_cp`` the final hidden rows all-gathered over ``model`` along
        the sequence first, as the reference gathers them) and the result
        is this
        rank's share of the batch's mean: the shares of the data ranks sum
        to it. Where the data axis does not divide the batch, every data
        rank holds all of it (``global_rows`` == B) and its share is the
        mean over the data axis's size, so that neither the loss nor the
        gradients summed over ``data`` count the batch more than once."""
        split = self._seq_split(tokens.shape[1])
        hidden = self.backbone(tokens, extras)
        ctx = self.ctx
        w = self.unembed_weight()
        B, S = tokens.shape
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
            hidden = (C.all_gather(hidden, "tp", 1, ctx) if split
                      else C.enter(hidden, "tp", ctx))
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
        FFN. On a live mesh every entry holds the rank's lanes and heads,
        as :meth:`cache`'s blocks do; in ``fsdp_cp`` the K/V hold the
        rank's rows of the sequence and every head
        (:meth:`_prefill_seq_split`), which :meth:`fill_cache` moves to
        the cache's rows."""
        cfg, ctx = self.cfg, self.ctx
        if self._seq_split(tokens.shape[1]):
            return self._prefill_seq_split(tokens)
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
                o, c = M2.ssm_full(blk.weights("ssm", ctx), x, cfg, ctx)
                parts["state"].append(c["state"])
                parts["conv"].append(c["conv"])
            x = x + o
            if blk.cross is not None:
                o, ck, cv = L.attn_full(blk.weights("cross", ctx), x, cfg,
                                        positions, kv_src=src, causal=False,
                                        ctx=ctx)
                x = x + o
                parts["cross_k"].append(ck)
                parts["cross_v"].append(cv)
            x = blk.ffn_apply(x, cfg, ctx)
        x = rms_norm(x, self.final_ln, cfg.norm_eps)
        kv = (torch.stack(ks), torch.stack(vs)) if ks else (None, None)
        state = {name: torch.stack(ts) for name, ts in parts.items() if ts}
        return (self._logits(x[:, -1]), *kv, state or None)

    def _prefill_seq_split(self, tokens: torch.Tensor):
        """The prefill of ``tp_sp_opt`` and ``fsdp_cp`` (dense and MoE
        stacks): the residual is the rank's [B, S/tp, D] rows between the
        layers, the embedding reduce-scattered to them. ``tp_sp_opt``:
        each attention and FFN all-gathers its normed rows over ``model``
        once and reduce-scatters its partial sums back (Megatron sequence
        parallelism); the K/V are the rank's heads over the whole
        sequence. ``fsdp_cp``: each layer's weights gathered whole, the
        attention context-parallel (:func:`layers.attn_context_parallel`),
        the FFN on the rank's rows alone; the K/V are the rank's rows of
        every head. The MoE routes the rank's rows as they come. The last
        row's logits are those of ``model``'s last rank, all-gathered."""
        cfg, ctx = self.cfg, self.ctx
        x = self.embed(tokens, sp=True)
        positions = self._positions(tokens.shape[1], True, tokens.device)
        n_kv = len(self.kv_layer)
        ks, vs = [None] * n_kv, [None] * n_kv
        for i, blk in enumerate(self.layers):
            o, k, v = self._attn_seq_split(blk, x, positions)
            ks[self.kv_layer[i]], vs[self.kv_layer[i]] = k, v
            x = blk.ffn_apply(x + o, cfg, ctx, sp=True)
        x = rms_norm(x, self.final_ln, cfg.norm_eps)
        last = C.all_gather(x[:, -1:].contiguous(), "tp", 1, ctx,
                            grad="block")[:, -1]
        return self._logits(last), torch.stack(ks), torch.stack(vs), None

    def fill_cache(self, cache: Dict[str, torch.Tensor], k, v,
                   state: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """Put a prefill's K/V ([n_attn_layers, B, P, Hkv, hd], this
        rank's block) and state (:meth:`prefill_with_state`'s) into the
        first P positions of :meth:`cache`'s ``cache``, in place. In
        ``fsdp_cp`` on a live mesh the K/V hold the rank's P/tp rows of
        the prompt; each layer's rows are all-gathered over ``model`` and
        the rank keeps those of its block of the cache's rows."""
        if k is not None:
            if self.ctx.live and self.ctx.mode == "fsdp_cp":
                S_loc = cache["k"].shape[2]
                lo = self.ctx.index("tp") * S_loc
                for a in range(k.shape[0]):
                    for src, dst in ((k, cache["k"]), (v, cache["v"])):
                        rows = C.all_gather(src[a], "tp", 1, self.ctx)
                        n = max(0, min(S_loc, rows.shape[1] - lo))
                        dst[a, :, :n] = rows[:, lo:lo + n]
                        del rows
            else:
                P = k.shape[2]
                cache["k"][:, :, :P] = k
                cache["v"][:, :, :P] = v
        for name, t in (state or {}).items():
            cache[name].copy_(t)

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
        with neither. On a live mesh H and di are this rank's ``H/tp`` and
        ``di/tp``, and Hkv its KV heads of the head layout (one where
        ``model`` exceeds them)."""
        cfg, dev = self.cfg, self.device
        out: Dict[str, torch.Tensor] = {}
        if self.n_ssm_layers:
            s, n = cfg.ssm, self.n_ssm_layers
            H = self.n_ssm_heads_local
            out["state"] = torch.zeros(
                (n, batch, H, s.d_state, s.head_dim),
                dtype=torch.float32, device=dev)
            out["conv"] = torch.zeros(
                (n, batch, s.conv_dim - 1, H * s.head_dim), dtype=cfg.dtype,
                device=dev)
        if self.cross_layer:
            shape = (len(self.cross_layer), batch, cfg.n_ctx,
                     self.n_kv_local, cfg.head_dim_)
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
        mesh ``batch`` is the rank's lanes and each entry its heads'
        block: the K/V and the cross K/V are split by KV heads over
        ``model``, where the reference's ``cache_specs`` split their
        sequence (``kv_sp``), the SSM state by heads and the conv window
        by channels, as the reference's. In ``fsdp_cp`` the K/V are split
        by sequence (``kv_sp``), as the reference's: rank m of ``model``
        holds rows m S/tp .. of every head, S a multiple of
        ``page_tokens`` times the model axis."""
        out = self.state_cache(batch)
        if self.kv_layer:
            cfg = self.cfg
            S = self._cache_rows(s_max, page_tokens)
            if self.ctx.live and self.ctx.mode == "fsdp_cp":
                S //= self.ctx.axis_size("tp")
            shape = (len(self.kv_layer), batch, S, self.n_kv_local,
                     cfg.head_dim_)
            out["k"] = torch.zeros(shape, dtype=cfg.dtype, device=self.device)
            out["v"] = torch.zeros(shape, dtype=cfg.dtype, device=self.device)
        return out

    def _cache_rows(self, s_max: int, page_tokens: int) -> int:
        """The dense cache's rows for ``s_max`` tokens: whole pages, and in
        ``fsdp_cp`` whole pages on every rank of ``model``."""
        unit = page_tokens * (self.ctx.axis_size("tp")
                              if self.ctx.mode == "fsdp_cp" else 1)
        return -(-s_max // unit) * unit

    def cache_specs(self, batch: int, seq: int, page_tokens: int = 16):
        """(shape/dtype tree, partition-spec tree) of :meth:`cache`'s
        entries for ``batch`` lanes of ``seq`` tokens: nothing allocated.
        Each entry stacks its layers on a leading dim that no mesh axis
        splits; the rest is split as the reference's ``cache_specs``
        splits a slot's cache (lanes over the batch axes, K/V rows over
        ``kv_sp``, SSM heads and conv channels over ``tp``), but on a live
        mesh, whose K/V and cross K/V :meth:`cache` splits by KV heads
        (``tp``) instead of rows. Where a live mesh's ``model`` exceeds the
        KV heads the spec leaves them whole, while each rank holds one,
        replicated (:meth:`cache` allocates the rank's blocks). In
        ``fsdp_cp`` the K/V rows are split over ``kv_sp`` on every mesh."""
        cfg, ctx = self.cfg, self.ctx
        kv_axes = (("batch", None, "tp", None)
                   if ctx.live and ctx.mode != "fsdp_cp"
                   else ("batch", "kv_sp", None, None))
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
                              cfg.head_dim_), cfg.dtype, kv_axes)
        if n_kv:
            S = self._cache_rows(seq, page_tokens)
            for name in ("k", "v"):
                raw[name] = ((n_kv, batch, S, cfg.n_kv_heads, cfg.head_dim_),
                             cfg.dtype, kv_axes)
        structs = {k: TensorSpec(shp, dt) for k, (shp, dt, _) in raw.items()}
        specs = {k: (None,) + ctx.spec(*axes, dims=shp[1:])
                 for k, (shp, _, axes) in raw.items()}
        return structs, specs

    def decode_step(self, cache: Dict[str, torch.Tensor],
                    tokens: torch.Tensor, positions: torch.Tensor,
                    page_tokens: int = 16,
                    global_rows: Optional[int] = None) -> torch.Tensor:
        """One token for every lane from the dense decode cache
        (:meth:`cache`, updated in place; :meth:`state_cache` alone for a
        pure-SSM model): the reference's ``decode_step``. tokens [B,1];
        positions [B] the new token's index. An attention layer writes the
        token's K/V into its lane's dense cache and reads it back as pages
        of ``page_tokens`` through ``kernels.ops.paged_attention``; SSM
        layers step their state, cross layers read their static K/V, every
        lane, idle ones too, as the reference's do. Returns logits [B,Vp]
        f32. On a live mesh: the rank's lanes, and :meth:`cache`'s blocks;
        ``global_rows`` is the lanes of the whole batch (default: B times
        the data axis; B itself where the data axis does not split it),
        which ``fsdp_cp``'s weight-stationary step
        (:meth:`_decode_stationary`) carries."""
        cfg, ctx = self.cfg, self.ctx
        if ctx.live and ctx.mode == "fsdp_cp":
            return self._decode_stationary(cache, tokens, positions,
                                           page_tokens, global_rows)
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
                x = x + M2.ssm_decode(blk.weights("ssm", ctx), x,
                                      cache["state"][j], cache["conv"][j],
                                      cfg, ctx)
                j += 1
            if blk.cross is not None:
                c = self.cross_layer[i]
                x = x + L.attn_decode_cross(blk.weights("cross", ctx), x,
                                            cfg, cache["cross_k"][c],
                                            cache["cross_v"][c], ctx)
            x = blk.ffn_apply(x, cfg, ctx)
        x = rms_norm(x, self.final_ln, cfg.norm_eps)
        return self._logits(x[:, 0])

    def _decode_stationary(self, cache, tokens, positions, page_tokens: int,
                           global_rows: Optional[int]) -> torch.Tensor:
        """``fsdp_cp``'s decode step (the reference's ``decode_step`` in that
        mode): weight-stationary, no weight gathered. The rank's tokens
        [b, 1] are all-gathered over ``data`` (where it splits the lanes)
        to every lane's; the residual is [B, 1, D/dp], every lane and the
        rank's block of ``D`` (the embedding's masked lookup in the
        table's block, summed over ``model``). Each layer:
        :func:`layers.attn_decode_stationary` over the sequence-split
        cache (the rank's lanes) and the stationary FFN or MoE. The
        unembedding sums the [B, Vp/tp] partials of the rank's block of
        the head over ``data`` and all-gathers them over ``model``.
        Returns the rank's lanes' logits [b, Vp] f32."""
        cfg, ctx = self.cfg, self.ctx
        b, dp = tokens.shape[0], ctx.axis_size("batch")
        rows = b * dp if global_rows is None else global_rows
        if rows not in (b, b * dp):
            raise ValueError(f"{b} lanes on a rank of a data axis of {dp} "
                             f"ranks: not a block of a batch of {rows}")
        split = rows != b
        lo = ctx.index("batch") * b if split else 0
        if split:
            tokens = C.all_gather(tokens.contiguous(), "batch", 0, ctx)
        x = self.embed(tokens, stationary=True)               # [B, 1, D/dp]
        for i, blk in enumerate(self.layers):
            a = self.kv_layer[i]
            x = x + L.attn_decode_stationary(
                blk.attn, x, cfg, positions, cache["k"][a], cache["v"][a],
                page_tokens, (lo, lo + b), ctx)
            x = blk.ffn_stationary(x, cfg, ctx, split)
        x = L.norm_split(x[:, 0], self.final_ln, cfg, ctx)    # [B, D/dp]
        part = C.all_reduce_sum((x @ self.unembed_weight()).float(), "fsdp",
                                ctx)
        logits = C.all_gather(part, "tp", 1, ctx)
        return logits[lo:lo + b]
