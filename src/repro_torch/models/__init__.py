"""Public model API: ``build_model(cfg_or_name, params=None, device=...)``."""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, get_config
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.models.common import abstract_tree, init_params, param_specs
from repro_torch.models.transformer import Model


def build_model(cfg: Union[str, ArchConfig],
                params: Optional[Dict[str, Any]] = None, *,
                device=None, seed: int = 0, trainable: bool = False,
                mesh=None) -> Model:
    """A :class:`Model` on ``device`` (``cuda`` unless the caller names
    another), frozen unless ``trainable``. Without ``params`` the weights
    are drawn by :func:`init_params` from a ``torch.Generator`` on the
    device seeded with ``seed``; on ``device="meta"`` the model is
    weightless, its parameters :meth:`Model.abstract_params` (the dry
    run's model). ``mesh`` sets the sharding context the launch tooling
    reads (:mod:`repro_torch.distributed.sharding`)."""
    if isinstance(cfg, str):
        cfg = get_config(cfg)
    device = resolve_device(device)
    if params is None and device.type == "meta":
        params = abstract_tree(param_specs(cfg))
    elif params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        params = init_params(cfg, gen, device)
    model = Model(cfg, params, trainable).to(device)
    model.ctx = ShardingCtx(mesh)
    return model


__all__ = ["Model", "build_model", "init_params"]
