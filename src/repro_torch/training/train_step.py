"""Train and prefill step builders: the loss, its gradients with optional
microbatch accumulation, and the AdamW update.

The port of ``repro/training/train_step.py``. Where the reference returns
pure functions for ``jax.jit``, these run eagerly on the model's own
parameters: ``params`` is ``model.param_tree()``, whose tensors the update
changes in place, and each step is ``loss.backward()`` then
:func:`~repro_torch.training.optimizer.adamw_update`.

:func:`build_cell` is the counterpart of the reference's ``lower_cell``:
it returns a cell's step with its arguments, which for a model on ``meta``
(``build_model(cfg, device="meta")``) are abstract. Nothing is lowered or
compiled: the dry run (:mod:`repro_torch.launch.dryrun`) runs the step on
``meta`` under its counter, and the same call on a model on the card gives
the step the counter predicts. On a model across a live mesh the cells
hold each rank's block of the batch, of the cache (split by KV heads) and,
training, of the parameters and the AdamW state, as the reference's
``in_shardings`` place them; the train step sums each replicated leaf's
gradient over ``data``, takes the global grad norm and reports the
batch's loss, summed over ``data``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import input_specs, shape_of
from repro_torch.distributed import collectives as C
from repro_torch.models.transformer import Model
from repro_torch.training.optimizer import (OptConfig, abstract_opt_state,
                                            adamw_init, adamw_update)
from repro_torch.tree import leaves, tree_map


def _split_batch(batch: Dict[str, torch.Tensor]):
    toks = batch["tokens"]
    labels = batch.get("labels")
    extras = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
    return toks, labels, extras


def make_loss_fn(model: Model, global_rows: Optional[int] = None):
    """loss_fn(params, batch) -> the model's mean cross-entropy (the
    parameters are the model's own; ``params`` is taken for the
    reference's signature). On a live mesh ``batch`` is this rank's rows
    of a batch of ``global_rows`` (:meth:`Model.loss`) and the loss this
    rank's share."""
    def loss_fn(params, batch):
        toks, labels, extras = _split_batch(batch)
        return model.loss(toks, labels, extras, global_rows=global_rows)
    return loss_fn


def loss_and_grads(model: Model, batch: Dict[str, torch.Tensor],
                   global_rows: Optional[int] = None):
    """The loss of ``batch`` and the gradients of the model's parameters
    (:meth:`Model.grad_tree`, this rank's blocks on a live mesh, each
    replicated leaf's summed over ``data``): ``(loss, grads)``, the loss
    this rank's share (:meth:`Model.loss`), detached."""
    model.zero_grad(set_to_none=True)
    loss = make_loss_fn(model, global_rows)(None, batch)
    loss.backward()
    model.sum_grads_over_data()
    return loss.detach(), model.grad_tree()


def make_train_step(model: Model, opt_cfg: OptConfig, n_micro: int = 1,
                    global_batch: Optional[int] = None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics): ``params`` (``model.param_tree()``) and ``opt_state`` updated
    in place; metrics ``{"loss", "grad_norm", "lr"}`` as 0-d f32 tensors.

    With ``n_micro`` > 1 the batch is cut along its first axis into
    ``n_micro`` equal microbatches (microbatch i holds rows i * b ..
    (i + 1) * b - 1), their gradients are summed in f32 and divided by
    ``n_micro``, and the loss is their mean, as the reference's scan
    does.

    On a live mesh ``batch`` is this rank's rows of a batch of
    ``global_batch`` rows (default: its rows times the data axis), whose
    own rows the microbatches split; ``params`` and ``opt_state`` are the
    rank's blocks. The grad norm is global, and the loss reported is the
    batch's, summed over ``data``."""
    ctx = model.ctx
    places = model.placements() if ctx.live else None
    if global_batch is not None and global_batch % n_micro:
        raise ValueError(f"a batch of {global_batch} does not split into "
                         f"{n_micro} microbatches")
    rows = None if global_batch is None else global_batch // n_micro

    def grads_of(params, batch):
        return loss_and_grads(model, batch, rows)

    def train_step(params, opt_state, batch):
        if n_micro == 1:
            loss, grads = grads_of(params, batch)
        else:
            b = batch["tokens"].shape[0]
            if b % n_micro:
                raise ValueError(f"a batch of {b} does not split into "
                                 f"{n_micro} microbatches")
            mb = b // n_micro
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            for i in range(n_micro):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l, g = grads_of(params, part)
                with torch.no_grad():
                    for acc, gi in zip(leaves(grads), leaves(g)):
                        acc.add_(gi)
                loss = loss + l
                del g
            model.zero_grad(set_to_none=True)
            loss = loss / n_micro
            with torch.no_grad():
                for acc in leaves(grads):
                    acc.div_(n_micro)
        params, opt_state, metrics = adamw_update(grads, opt_state, params,
                                                  opt_cfg, ctx, places)
        model.zero_grad(set_to_none=True)
        metrics["loss"] = C.all_reduce_sum(loss, "batch", ctx)
        return params, opt_state, metrics

    return train_step


def make_prefill_step(model: Model):
    """prefill_step(params, batch) -> the model's prefill (last-token
    logits and the prompt's K/V)."""
    def prefill_step(params, batch):
        toks, _, extras = _split_batch(batch)
        return model.prefill(toks, extras)
    return prefill_step


def make_decode_step(model: Model):
    """decode_step(params, cache, tokens, positions) -> logits [B, Vp]
    f32: one token per lane from the dense decode cache (``Model.cache``),
    updated in place."""
    def decode_step(params, cache, tokens, positions):
        return model.decode_step(cache, tokens, positions)
    return decode_step


# ---------------------------------------------------------------------------
# A cell's step and its arguments (the dry run's; the reference's AOT in/out)
# ---------------------------------------------------------------------------

def batch_pspecs(model: Model, shape) -> Dict[str, Tuple]:
    """Partition spec per batch input: the batch dim over the data axes
    where they divide it, the rest replicated."""
    ctx = model.ctx
    specs = {}
    for k, s in input_specs(model.cfg, shape).items():
        axes = ("batch",) + (None,) * (len(s.shape) - 1)
        specs[k] = ctx.spec(*axes, dims=s.shape)
    return specs


def cell_batch(model: Model, shape,
               generator: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
    """A cell's batch on the model's device: ``meta`` tensors for a model
    on ``meta``; else token ids drawn from ``generator`` below the
    vocabulary, labels the tokens shifted by one, standard-normal modality
    embeddings and, for a decode cell, positions ``seq_len - 1`` (the new
    token reads the whole cache)."""
    dev = model.device
    specs = input_specs(model.cfg, shape)
    if dev.type == "meta":
        return {k: torch.empty(s.shape, dtype=s.dtype, device=dev)
                for k, s in specs.items()}
    out = {}
    for k, s in specs.items():
        if k in ("tokens", "labels"):
            out[k] = torch.randint(0, model.cfg.vocab, s.shape,
                                   generator=generator, dtype=s.dtype,
                                   device=dev)
        elif k == "positions":
            out[k] = torch.full(s.shape, shape_of(shape)["seq_len"] - 1,
                                dtype=s.dtype, device=dev)
        else:
            out[k] = torch.randn(s.shape, generator=generator,
                                 dtype=torch.float32, device=dev).to(s.dtype)
    if "labels" in out:
        out["labels"] = torch.roll(out["tokens"], -1, 1)
    return out


def build_cell(model: Model, shape, opt_cfg: Optional[OptConfig] = None,
               n_micro: int = 1,
               generator: Optional[torch.Generator] = None
               ) -> Tuple[Any, Tuple[Any, ...]]:
    """The step of one (arch, shape) cell and its arguments: ``(step,
    args)``, ``step(*args)`` one step. The counterpart of the reference's
    ``lower_cell``, which lowers the step for XLA; nothing is lowered here.

    ``shape`` is a name of ``SHAPES`` or a dict with its keys. train:
    ``make_train_step(model, opt_cfg, n_micro)`` over (the model's
    parameters, AdamW state, batch); prefill: ``make_prefill_step`` over
    (parameters, batch); decode: ``make_decode_step`` over (parameters,
    ``Model.cache`` of ``global_batch`` lanes of ``seq_len`` tokens, tokens
    [B, 1], positions [B]). The arguments live on the model's device: on
    ``meta`` (``build_model(cfg, device="meta")``) they are abstract and
    nothing is allocated; elsewhere the state and cache are zeros and the
    batch is :func:`cell_batch`'s. On a live mesh each rank holds its rows
    of the batch (:func:`batch_pspecs`; all of it where the data axis does
    not divide it), :meth:`Model.cache`'s block for them and, training,
    the AdamW state of its blocks of the parameters
    (:func:`~repro_torch.training.optimizer.opt_pspecs`); ``n_micro``
    splits each rank's rows."""
    sh = shape_of(shape)
    params = model.param_tree()
    meta = model.device.type == "meta"
    ctx = model.ctx
    batch = cell_batch(model, sh, generator)
    if ctx.live:
        specs = batch_pspecs(model, sh)
        batch = {k: ctx.local_block(v, specs[k], k) for k, v in batch.items()}
    if sh["kind"] == "train":
        opt_cfg = opt_cfg or OptConfig()
        opt = (abstract_opt_state(params, opt_cfg.compression) if meta
               else adamw_init(params, opt_cfg.compression))
        step = make_train_step(model, opt_cfg, n_micro,
                               sh["global_batch"] if ctx.live else None)
        return step, (params, opt, batch)
    if sh["kind"] == "prefill":
        return make_prefill_step(model), (params, batch)
    B, S = batch["tokens"].shape[0], sh["seq_len"]
    if meta:
        structs, _ = model.cache_specs(B, S)
        cache = {k: torch.empty(s.shape, dtype=s.dtype, device="meta")
                 for k, s in structs.items()}
    else:
        cache = model.cache(B, S)
    return make_decode_step(model), (params, cache, batch["tokens"],
                                     batch["positions"])
