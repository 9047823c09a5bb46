"""AdamW with f32 moments over (possibly bf16) parameters, plus the
optional gradient compression (bf16 / int8 with error feedback) that models
the wire format of a data-parallel all-reduce.

The port of ``repro/training/optimizer.py`` with its arithmetic and cast
points: f32 moments, the global-norm clip, linear warmup, bias correction,
decoupled weight decay, the update computed in f32 and cast back to each
parameter's dtype. The trees are the port's (``Model.param_tree()``'s
layout, walked by :mod:`repro_torch.tree`). Where the reference returns
new trees, the port updates the parameters and the state in place, under
``torch.no_grad()``, one leaf at a time, so the f32 temporaries stay one
leaf's size. :func:`abstract_opt_state` and :func:`opt_pspecs` serve the
dry run (:mod:`repro_torch.launch.dryrun`): the state on ``meta`` and its
partition specs, the parameters' own.

Across a live mesh (``ctx`` and the leaves'
:func:`~repro_torch.distributed.sharding.placements`) every rank updates
its own blocks of the parameters and of the state, elementwise as on one
card; the grad norm is global (each rank's squares, each leaf counted on
one rank of its replicas, a KV block replicated over ranks of the
``model`` line too, summed over the mesh) and the int8 scale is the max
over the ranks that split the leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import LINE
from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # gradient compression: none | bf16 | int8 (error feedback kept in state)
    compression: str = "none"
    warmup_steps: int = 100


def _zeros32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def adamw_init(params, compression: str = "none") -> Dict[str, Any]:
    """f32 zeros for ``m`` and ``v`` (and the error-feedback residual
    ``ef`` when compressing) in the parameters' layout and on their device;
    ``step`` an int32 scalar."""
    dev = leaves(params)[0].device
    state = {"m": tree_map(_zeros32, params),
             "v": tree_map(_zeros32, params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if compression != "none":
        state["ef"] = tree_map(_zeros32, params)
    return state


def abstract_opt_state(abstract_params, compression: str = "none"
                       ) -> Dict[str, Any]:
    """:func:`adamw_init`'s state for parameters of these shapes, as
    ``meta`` tensors: nothing allocated."""
    f32 = lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta")
    state = {"m": tree_map(f32, abstract_params),
             "v": tree_map(f32, abstract_params),
             "step": torch.empty((), dtype=torch.int32, device="meta")}
    if compression != "none":
        state["ef"] = tree_map(f32, abstract_params)
    return state


def opt_pspecs(param_pspecs, compression: str = "none") -> Dict[str, Any]:
    """The state's partition specs: the moments (and the residual) split
    as their parameters, the step replicated."""
    state = {"m": param_pspecs, "v": param_pspecs, "step": ()}
    if compression != "none":
        state["ef"] = param_pspecs
    return state


def _compress(g: torch.Tensor, ef: torch.Tensor, how: str, ctx=None,
              place=None) -> torch.Tensor:
    g = g.float() + ef
    if how == "bf16":
        q = g.bfloat16().float()
    elif how == "int8":
        top = g.abs().max()
        for axis in (place.split if place is not None else ()):
            top = C.all_reduce_max(top, LINE[axis], ctx)
        scale = torch.clamp(top, min=1e-12) / 127.0
        q = torch.round(g / scale).to(torch.int8).float() * scale
    else:
        raise ValueError(how)
    ef.copy_(g - q)
    return q


def compress_grads(grads, state: Dict[str, Any], cfg: OptConfig, ctx=None,
                   places=None):
    """Lossy-compress the gradients with error feedback: returns the
    decompressed f32 gradients, and the state with its residual ``ef``
    updated in place. On a live mesh (``ctx``, ``places`` the leaves'
    placements) the int8 scale is the max over the whole leaf."""
    if cfg.compression == "none":
        return grads, state
    places = places or tree_map(lambda g: None, grads)
    with torch.no_grad():
        return tree_map(lambda g, e, pl: _compress(g, e, cfg.compression,
                                                   ctx, pl),
                        grads, state["ef"], places), state


def global_norm(tree, ctx=None, places=None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares, added
    in leaf order. On a live mesh (``ctx``, ``places`` the leaves'
    placements) the leaves are this rank's blocks: a leaf counts on the
    ranks at index 0 of each axis it is replicated over (and a KV block
    shared by ranks of the ``model`` line, on the first of them), and the
    sum runs over ``data`` and ``model``."""
    ls = leaves(tree)
    sq = torch.zeros((), dtype=torch.float32, device=ls[0].device)
    for x, pl in zip(ls, leaves(places) if places else [None] * len(ls)):
        if pl is None or (all(ctx.index(LINE[a]) == 0 for a in pl.replicated)
                          and (pl.shared == 1 or ctx.index("kv") == 0)):
            sq = sq + x.float().square().sum()
    for axis in LINE:
        sq = C.all_reduce_sum(sq, LINE[axis], ctx)
    return sq.sqrt()


def adamw_update(grads, state: Dict[str, Any], params, cfg: OptConfig,
                 ctx=None, places=None
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: ``params`` and ``state`` are updated in place and
    returned, with the metrics ``{"grad_norm", "lr"}`` (0-d f32 tensors on
    the parameters' device: nothing here waits for the device). On a live
    mesh ``ctx`` and ``places`` (the leaves'
    :func:`~repro_torch.distributed.sharding.placements`) make the norm
    and the int8 scale global; the update is each rank's blocks'."""
    if ctx is None or not ctx.live:
        ctx = places = None
    with torch.no_grad():
        grads, state = compress_grads(grads, state, cfg, ctx, places)
        gnorm = global_norm(grads, ctx, places)
        clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-12), max=1.0)
        step = state["step"] + 1
        warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
        lr = cfg.lr * warm
        b1c = 1 - cfg.b1 ** step.float()
        b2c = 1 - cfg.b2 ** step.float()
        for p, g, m, v in zip(leaves(params), leaves(grads),
                              leaves(state["m"]), leaves(state["v"])):
            g = g.float() * clip                  # a new tensor
            m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
            v.mul_(cfg.b2).add_(g.square_() * (1 - cfg.b2))
            del g
            delta = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
            pf = p.float()
            delta.add_(cfg.weight_decay * pf)
            p.copy_(pf - lr * delta)
        state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
