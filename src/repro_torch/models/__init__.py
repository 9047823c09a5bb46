"""Public model API: ``build_model(cfg_or_name, params=None, device=...)``."""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, get_config
from repro_torch.distributed.sharding import mesh_rules
from repro_torch.models.common import (abstract_tree, init_params,
                                       param_specs, pspec_tree)
from repro_torch.models.transformer import Model, sharding_ctx


def build_model(cfg: Union[str, ArchConfig],
                params: Optional[Dict[str, Any]] = None, *,
                device=None, seed: int = 0, trainable: bool = False,
                mesh=None, mode: str = "tp_sp") -> Model:
    """A :class:`Model` on ``device`` (``cuda`` unless the caller names
    another), frozen unless ``trainable``. Without ``params`` the weights
    are drawn by :func:`init_params` from a ``torch.Generator`` on the
    device seeded with ``seed``; on ``device="meta"`` the model is
    weightless, its parameters :meth:`Model.abstract_params` (the dry
    run's model). ``mesh`` sets the sharding context
    (:mod:`repro_torch.distributed.sharding`): a production mesh is data
    the launch tooling reads; on a live mesh
    (:func:`repro_torch.launch.mesh.make_local_mesh`) ``params`` are the
    whole tree and the model keeps this rank's block of each leaf, or,
    without ``params``, each leaf is drawn whole from ``seed`` (the same
    on every rank) and cut to its block before the next is drawn
    (:func:`init_params`), so a rank never holds the whole model. The
    attention's leaves are cut by the head layout
    (:func:`~repro_torch.distributed.sharding.head_layout`; in
    ``fsdp_cp`` the partition specs' equal blocks). ``mode`` is the
    reference's distribution mode (``tp_sp``, ``tp_sp_opt`` or
    ``fsdp_cp``: :mod:`repro_torch.distributed.sharding`). Raises
    ``ValueError`` for a leaf the mesh does not divide, heads it cannot
    lay out or an unknown mode, and ``NotImplementedError`` for a family
    the mode does not run yet."""
    if isinstance(cfg, str):
        cfg = get_config(cfg)
    device = resolve_device(device)
    ctx = sharding_ctx(cfg, mesh, mode)
    if params is None and device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        params = init_params(cfg, gen, device, ctx)
    else:
        if params is None:
            params = abstract_tree(param_specs(cfg))
        if ctx.live:
            params = ctx.shard_tree(params, pspec_tree(param_specs(cfg),
                                                       mesh_rules(mesh)))
    return Model(cfg, params, trainable, mesh=mesh, mode=mode).to(device)


__all__ = ["Model", "build_model", "init_params"]
