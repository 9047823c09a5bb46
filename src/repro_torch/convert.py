"""Weights of the JAX reference, as numpy arrays, into the port's layout.

The reference stacks each repeated layer group on a leading axis
(``params["groups"]["slot0"]`` for a dense or a pure-SSM stack, one entry
per layer); the port keeps one dict per layer. Values are copied
unchanged, each leaf in the dtype its spec gives (the config's, or float32
for a Mamba2 layer's ``A_log``/``dt_bias``/``D_skip``), so the two packages
compute with the same numbers.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import layer_specs


def _tensor(a: Any, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, which torch.from_numpy refuses: same bits
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def params_from_jax(tree: Dict[str, Any], cfg: ArchConfig,
                    device=None) -> Dict[str, Any]:
    """``tree``: the reference ``Model.init`` tree mapped to numpy
    (``jax.tree.map(np.asarray, params)``) for the config of the same name.
    Returns the port's parameter dict on ``device``."""
    device = resolve_device(device)
    groups = tree["groups"]
    if set(groups) != {"slot0"}:
        raise NotImplementedError(
            f"{cfg.name}: only dense and pure-SSM stacks (one layer slot) "
            f"convert, got slots {sorted(groups)}")
    slot = groups["slot0"]
    t = lambda a: _tensor(a, cfg.dtype, device)          # noqa: E731
    layers = []
    for i in range(cfg.n_layers):
        specs = layer_specs(cfg, i)
        layers.append({
            part: {k: _tensor(v[i], specs[part][k].dtype or cfg.dtype,
                              device) for k, v in slot[part].items()}
            for part in specs})
    params: Dict[str, Any] = {
        "embed": t(tree["embed"]),
        "final_ln": t(tree["final_ln"]),
        "layers": layers,
    }
    if "lm_head" in tree:
        params["lm_head"] = t(tree["lm_head"])
    return params
