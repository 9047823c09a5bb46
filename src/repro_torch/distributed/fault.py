"""Fault tolerance + straggler mitigation for 1000+-node operation.

``StragglerDetector`` — EWMA step-time tracking with z-score outlier calls;
the cluster manager re-dispatches work from flagged nodes (the simulator and
the serving engine both consult it).

``ElasticController`` — plans recovery after node failures: chooses the
largest feasible mesh from the survivors, and the restore path re-shards the
latest checkpoint onto it (repro_torch.checkpoint.restore with new shardings).
This is checkpoint-restart elasticity: no in-flight state migration, which
matches how large TPU fleets actually recover.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class StragglerDetector:
    def __init__(self, alpha: float = 0.2, z_thresh: float = 3.0,
                 min_obs: int = 8):
        self.alpha = alpha
        self.z = z_thresh
        self.min_obs = min_obs
        self.mean: Dict[int, float] = {}
        self.var: Dict[int, float] = {}
        self.count: Dict[int, int] = {}

    def observe(self, node: int, step_s: float) -> None:
        m = self.mean.get(node, step_s)
        v = self.var.get(node, 0.0)
        d = step_s - m
        self.mean[node] = m + self.alpha * d
        self.var[node] = (1 - self.alpha) * (v + self.alpha * d * d)
        self.count[node] = self.count.get(node, 0) + 1

    def is_straggler(self, node: int, step_s: float) -> bool:
        """Is this step-time an outlier vs the FLEET distribution?"""
        if len(self.mean) < 2 or self.count.get(node, 0) < self.min_obs:
            return False
        fleet = np.array([self.mean[n] for n in self.mean if n != node])
        mu, sd = float(fleet.mean()), float(fleet.std() + 1e-9)
        return (step_s - mu) / sd > self.z

    def forget(self, node: int) -> None:
        """Drop a node's history when it leaves the fleet (death or
        retirement) so its stale mean stops skewing the fleet distribution
        every later node is judged against."""
        self.mean.pop(node, None)
        self.var.pop(node, None)
        self.count.pop(node, None)

    def stragglers(self) -> List[int]:
        if len(self.mean) < 3:
            return []
        vals = np.array(list(self.mean.values()))
        mu, sd = float(vals.mean()), float(vals.std() + 1e-9)
        return [n for n, m in self.mean.items()
                if (m - mu) / sd > self.z
                and self.count.get(n, 0) >= self.min_obs]


@dataclasses.dataclass
class RecoveryPlan:
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    dropped_nodes: Tuple[int, ...]
    restore_step: Optional[int]


class ElasticController:
    """Pick the largest viable (data, model) mesh from surviving chips and
    plan a checkpoint-restart onto it."""

    def __init__(self, model_axis: int = 16, min_data: int = 1):
        self.model_axis = model_axis
        self.min_data = min_data

    def plan(self, total_chips: int, failed: Sequence[int],
             ckpt_step: Optional[int]) -> Optional[RecoveryPlan]:
        alive = total_chips - len(failed)
        data = alive // self.model_axis
        if data < self.min_data:
            return None
        # power-of-two data axis keeps batch divisibility
        data = 1 << (data.bit_length() - 1)
        return RecoveryPlan(mesh_shape=(data, self.model_axis),
                            axis_names=("data", "model"),
                            dropped_nodes=tuple(failed),
                            restore_step=ckpt_step)
