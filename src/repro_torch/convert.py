"""Weights of the JAX reference, as numpy arrays, into the port's layout.

The reference stacks each slot of the repeating layer period on a leading
group axis (``params["groups"]["slot{s}"]``, ``n_groups = n_layers //
period`` entries each); the port keeps one dict per layer: layer ``i`` is
group ``i // period`` of slot ``i % period``, its ``cross`` part included.
The encoder's layers, stacked on a leading ``[n_enc]`` axis in the
reference, become one dict per encoder layer likewise. Values are copied
unchanged, each leaf in the dtype its spec gives (the config's, or
float32 for a Mamba2 layer's ``A_log``/``dt_bias``/``D_skip``), so the
two packages compute with the same numbers. :func:`tree_from_jax` maps
any tree of the parameters' layout (a gradient, an optimizer moment)
without the cast, and :func:`opt_state_from_jax` the reference's AdamW
state.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import encoder_layer_specs, layer_specs


def _tensor(a: Any, dtype: Optional[torch.dtype],
            device: torch.device) -> torch.Tensor:
    """``a`` as a tensor on ``device`` in ``dtype`` (None: its own)."""
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, which torch.from_numpy refuses: same bits
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_jax(tree: Dict[str, Any], cfg: ArchConfig,
                    device=None) -> Dict[str, Any]:
    """``tree``: the reference ``Model.init`` tree mapped to numpy
    (``jax.tree.map(np.asarray, params)``) for the config of the same name.
    Returns the port's parameter dict on ``device``."""
    return _from_jax(tree, cfg, resolve_device(device), cast=True)


def tree_from_jax(tree: Dict[str, Any], cfg: ArchConfig,
                  device=None) -> Dict[str, Any]:
    """:func:`params_from_jax` with every leaf kept in its own dtype: a
    tree of the parameters' layout (the reference's gradients, in the
    parameters' dtypes; its f32 optimizer moments) in the port's."""
    return _from_jax(tree, cfg, resolve_device(device), cast=False)


def opt_state_from_jax(state: Dict[str, Any], cfg: ArchConfig,
                       device=None) -> Dict[str, Any]:
    """The reference's ``adamw_init`` / ``adamw_update`` state mapped to
    numpy into the port's (:func:`repro_torch.training.adamw_init`'s
    layout): ``m``, ``v`` (and ``ef``) as f32 whatever the config's dtype,
    ``step`` an int32 scalar."""
    device = resolve_device(device)
    out = {k: _from_jax(state[k], cfg, device, cast=False,
                        dtype=torch.float32)
           for k in ("m", "v", "ef") if k in state}
    out["step"] = torch.tensor(int(np.asarray(state["step"])),
                               dtype=torch.int32, device=device)
    return out


def _from_jax(tree: Dict[str, Any], cfg: ArchConfig, device: torch.device,
              cast: bool, dtype: Optional[torch.dtype] = None
              ) -> Dict[str, Any]:
    """The reference's stacked layout into the port's, each leaf in
    ``dtype``, else (``cast``) its spec's dtype, else its own."""
    groups = tree["groups"]
    period = cfg.layer_pattern_period
    if set(groups) != {f"slot{s}" for s in range(period)}:
        raise ValueError(f"{cfg.name}: a period of {period} layer slots, "
                         f"got slots {sorted(groups)}")
    def t(a, spec=None):
        want = dtype or (((spec and spec.dtype) or cfg.dtype) if cast
                         else None)
        return _tensor(a, want, device)

    layers = []
    for i in range(cfg.n_layers):
        specs = layer_specs(cfg, i)
        slot, g = groups[f"slot{i % period}"], i // period
        layers.append({
            part: {k: t(v[g], specs[part][k]) for k, v in slot[part].items()}
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
