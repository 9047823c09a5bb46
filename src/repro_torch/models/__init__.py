"""Public model API: ``build_model(cfg_or_name, params=None, device=...)``."""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, get_config
from repro_torch.distributed.sharding import ShardingCtx, mesh_rules
from repro_torch.models.common import (abstract_tree, init_params,
                                       param_specs, pspec_tree)
from repro_torch.models.transformer import Model, check_mesh


def build_model(cfg: Union[str, ArchConfig],
                params: Optional[Dict[str, Any]] = None, *,
                device=None, seed: int = 0, trainable: bool = False,
                mesh=None) -> Model:
    """A :class:`Model` on ``device`` (``cuda`` unless the caller names
    another), frozen unless ``trainable``. Without ``params`` the weights
    are drawn by :func:`init_params` from a ``torch.Generator`` on the
    device seeded with ``seed``; on ``device="meta"`` the model is
    weightless, its parameters :meth:`Model.abstract_params` (the dry
    run's model). ``mesh`` sets the sharding context
    (:mod:`repro_torch.distributed.sharding`): a production mesh is data
    the launch tooling reads; on a live mesh
    (:func:`repro_torch.launch.mesh.make_local_mesh`) ``params`` (or the
    weights drawn from ``seed``, the same on every rank) are the whole
    tree and the model keeps this rank's block of each leaf, raising
    ``ValueError`` for a leaf the mesh does not divide."""
    if isinstance(cfg, str):
        cfg = get_config(cfg)
    device = resolve_device(device)
    if params is None and device.type == "meta":
        params = abstract_tree(param_specs(cfg))
    elif params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        params = init_params(cfg, gen, device)
    ctx = ShardingCtx(mesh)
    check_mesh(cfg, ctx)
    if ctx.live:
        params = ctx.shard_tree(params, pspec_tree(param_specs(cfg),
                                                   mesh_rules(mesh)))
    return Model(cfg, params, trainable, mesh=mesh).to(device)


__all__ = ["Model", "build_model", "init_params"]
