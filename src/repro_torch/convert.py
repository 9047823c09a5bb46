"""Weights of the JAX reference, as numpy arrays, into the port's layout.

The reference stacks each slot of the repeating layer period on a leading
group axis (``params["groups"]["slot{s}"]``, ``n_groups = n_layers //
period`` entries each); the port keeps one dict per layer: layer ``i`` is
group ``i // period`` of slot ``i % period``, its ``cross`` part included.
The encoder's layers, stacked on a leading ``[n_enc]`` axis in the
reference, become one dict per encoder layer likewise. Values are copied
unchanged, each leaf in the dtype its spec gives (the config's, or
float32 for a Mamba2 layer's ``A_log``/``dt_bias``/``D_skip``), so the
two packages compute with the same numbers.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import encoder_layer_specs, layer_specs


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
    period = cfg.layer_pattern_period
    if set(groups) != {f"slot{s}" for s in range(period)}:
        raise ValueError(f"{cfg.name}: a period of {period} layer slots, "
                         f"got slots {sorted(groups)}")
    t = lambda a: _tensor(a, cfg.dtype, device)          # noqa: E731
    layers = []
    for i in range(cfg.n_layers):
        specs = layer_specs(cfg, i)
        slot, g = groups[f"slot{i % period}"], i // period
        layers.append({
            part: {k: _tensor(v[g], specs[part][k].dtype or cfg.dtype,
                              device) for k, v in slot[part].items()}
            for part in specs})
    params: Dict[str, Any] = {
        "embed": t(tree["embed"]),
        "final_ln": t(tree["final_ln"]),
        "layers": layers,
    }
    if "lm_head" in tree:
        params["lm_head"] = t(tree["lm_head"])
    if cfg.encoder is not None:
        enc = tree["encoder"]
        specs = encoder_layer_specs(cfg)
        params["encoder"] = {
            "layers": [{part: {k: t(v[i]) for k, v in enc["layers"][part]
                               .items()}
                        for part in specs}
                       for i in range(cfg.encoder.n_layers)],
            "ln": t(enc["ln"])}
    return params
