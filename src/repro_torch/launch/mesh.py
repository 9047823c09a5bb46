"""Meshes as data: the port of ``repro/launch/mesh.py``.

A :class:`Mesh` holds a shape and axis names and no devices. The production
meshes are the reference's TPU pods, kept so that the dry run reports the
per-device shapes of their shardings; the port runs one card
(:func:`make_local_mesh`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> devices along it, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 single pod (256 chips) or 2x16x16 multi-pod (512 chips)."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_local_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A mesh over the CUDA devices present; raises when there are fewer
    than ``data * model``."""
    import torch
    n = data * model
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise ValueError(f"need {n} devices, have {have}")
    return Mesh(("data", "model"), (data, model))
