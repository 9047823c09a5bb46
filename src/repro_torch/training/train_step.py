"""Train and prefill step builders: the loss, its gradients with optional
microbatch accumulation, and the AdamW update.

The port of ``repro/training/train_step.py``. Where the reference returns
pure functions for ``jax.jit``, these run eagerly on the model's own
parameters: ``params`` is ``model.param_tree()``, whose tensors the update
changes in place, and each step is ``loss.backward()`` then
:func:`~repro_torch.training.optimizer.adamw_update`. The AOT lowering
(``lower_cell``, ``batch_pspecs``) and the dense KV-cache decode step
(``make_decode_step``) belong to the launch tooling, not ported yet.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.transformer import Model
from repro_torch.training.optimizer import OptConfig, adamw_update
from repro_torch.tree import leaves, tree_map


def _split_batch(batch: Dict[str, torch.Tensor]):
    toks = batch["tokens"]
    labels = batch.get("labels")
    extras = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
    return toks, labels, extras


def make_loss_fn(model: Model):
    """loss_fn(params, batch) -> the model's mean cross-entropy (the
    parameters are the model's own; ``params`` is taken for the
    reference's signature)."""
    def loss_fn(params, batch):
        toks, labels, extras = _split_batch(batch)
        return model.loss(toks, labels, extras)
    return loss_fn


def make_train_step(model: Model, opt_cfg: OptConfig, n_micro: int = 1):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics): ``params`` (``model.param_tree()``) and ``opt_state`` updated
    in place; metrics ``{"loss", "grad_norm", "lr"}`` as 0-d f32 tensors.

    With ``n_micro`` > 1 the batch is cut along its first axis into
    ``n_micro`` equal microbatches (microbatch i holds rows i * b ..
    (i + 1) * b - 1), their gradients are summed in f32 and divided by
    ``n_micro``, and the loss is their mean, as the reference's scan
    does."""
    loss_fn = make_loss_fn(model)

    def grads_of(params, batch):
        model.zero_grad(set_to_none=True)
        loss = loss_fn(params, batch)
        loss.backward()
        return loss.detach(), model.grad_tree()

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
                                                  opt_cfg)
        model.zero_grad(set_to_none=True)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_prefill_step(model: Model):
    """prefill_step(params, batch) -> the model's prefill (last-token
    logits and the prompt's K/V)."""
    def prefill_step(params, batch):
        toks, _, extras = _split_batch(batch)
        return model.prefill(toks, extras)
    return prefill_step
