"""Public model API: ``build_model(cfg_or_name, params=None, device=...)``."""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, get_config
from repro_torch.models.common import init_params
from repro_torch.models.transformer import Model


def build_model(cfg: Union[str, ArchConfig],
                params: Optional[Dict[str, Any]] = None, *,
                device=None, seed: int = 0) -> Model:
    """A :class:`Model` on ``device`` (``cuda`` unless the caller names
    another). Without ``params`` the weights are drawn by
    :func:`init_params` from a ``torch.Generator`` on the device seeded
    with ``seed``."""
    if isinstance(cfg, str):
        cfg = get_config(cfg)
    device = resolve_device(device)
    if params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        params = init_params(cfg, gen, device)
    return Model(cfg, params).to(device)


__all__ = ["Model", "build_model", "init_params"]
