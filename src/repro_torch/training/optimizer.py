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
leaf's size. The sharding and AOT helpers (``abstract_opt_state``,
``opt_pspecs``) belong to the launch tooling, not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

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


def _compress(g: torch.Tensor, ef: torch.Tensor, how: str) -> torch.Tensor:
    g = g.float() + ef
    if how == "bf16":
        q = g.bfloat16().float()
    elif how == "int8":
        scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
        q = torch.round(g / scale).to(torch.int8).float() * scale
    else:
        raise ValueError(how)
    ef.copy_(g - q)
    return q


def compress_grads(grads, state: Dict[str, Any], cfg: OptConfig):
    """Lossy-compress the gradients with error feedback: returns the
    decompressed f32 gradients, and the state with its residual ``ef``
    updated in place."""
    if cfg.compression == "none":
        return grads, state
    with torch.no_grad():
        return tree_map(lambda g, e: _compress(g, e, cfg.compression),
                        grads, state["ef"]), state


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares, added
    in leaf order."""
    ls = leaves(tree)
    sq = torch.zeros((), dtype=torch.float32, device=ls[0].device)
    for x in ls:
        sq = sq + x.float().square().sum()
    return sq.sqrt()


def adamw_update(grads, state: Dict[str, Any], params, cfg: OptConfig
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: ``params`` and ``state`` are updated in place and
    returned, with the metrics ``{"grad_norm", "lr"}`` (0-d f32 tensors on
    the parameters' device: nothing here waits for the device)."""
    with torch.no_grad():
        grads, state = compress_grads(grads, state, cfg)
        gnorm = global_norm(grads)
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
