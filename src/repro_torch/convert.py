"""Weights of the JAX reference, as numpy arrays, into the port's layout.

The reference stacks each repeated layer group on a leading axis
(``params["groups"]["slot0"]`` for a dense stack, one entry per layer);
the port keeps one dict per layer. Values are copied unchanged, so the two
packages compute with the same numbers.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig


def _tensor(a: Any, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device=device,
                                                       dtype=dtype)


def params_from_jax(tree: Dict[str, Any], cfg: ArchConfig,
                    device=None) -> Dict[str, Any]:
    """``tree``: the reference ``Model.init`` tree mapped to numpy
    (``jax.tree.map(np.asarray, params)``) for the config of the same name.
    Returns the port's parameter dict on ``device``."""
    device = resolve_device(device)
    groups = tree["groups"]
    if set(groups) != {"slot0"}:
        raise NotImplementedError(
            f"{cfg.name}: only dense stacks (one layer slot) convert, "
            f"got slots {sorted(groups)}")
    slot = groups["slot0"]
    t = lambda a: _tensor(a, cfg.dtype, device)          # noqa: E731
    params: Dict[str, Any] = {
        "embed": t(tree["embed"]),
        "final_ln": t(tree["final_ln"]),
        "layers": [{part: {k: t(v[i]) for k, v in slot[part].items()}
                    for part in ("attn", "ffn")}
                   for i in range(cfg.n_layers)],
    }
    if "lm_head" in tree:
        params["lm_head"] = t(tree["lm_head"])
    return params
