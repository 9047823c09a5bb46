"""Hierarchical weight residency + tiered LRU eviction (§III.C, Algorithm 1);
the port's copy of ``repro/core/runtime/residency.py``.

Model readiness states:
  RUNNING      — weights + execution context resident on the card
  SLEEPING     — weights offloaded to pinned host memory, warm context kept
                 (the node's engine object and its accountant registration)
  CPU          — weights cached in host memory, no warm context
  DISK         — weights on local disk
  REMOTE       — must be fetched from remote storage

Activation latency is a profiled bandwidth model: T_act ~ size / BW_tier,
summed over the tiers crossed (Remote->Disk->CPU->GPU), plus a cold-start
cost (:data:`RETRACE_COST_S`) when no warm context survives.
"""
from __future__ import annotations

import collections
import dataclasses
import enum
from typing import Dict, List, Optional, Tuple

from repro_torch.core.predictor.cost_model import HardwareSpec, ModelProfile


class ModelState(enum.Enum):
    RUNNING = "running"
    SLEEPING = "sleeping"
    CPU = "cpu"
    DISK = "disk"
    REMOTE = "remote"


# activation path: state -> list of (bw attribute, bytes multiplier)
_TIER_ORDER = [ModelState.RUNNING, ModelState.SLEEPING, ModelState.CPU,
               ModelState.DISK, ModelState.REMOTE]

# Cold-start cost when no warm context is retained. The reference's value
# (its estimate of a JAX re-trace), not measured on the card: nothing in the
# port re-traces. chip_smoke.py measures the port's cold-minus-warm
# activation on the H100 (PERF.md).
RETRACE_COST_S = 1.5


@dataclasses.dataclass
class ResidencyEvent:
    kind: str           # load | evict_to_cpu | evict_to_disk | drop
    model: str
    tier: str
    seconds: float


class HierarchicalResidency:
    """Algorithm 1 — cascading load-and-evict across GPU/CPU/disk tiers."""

    def __init__(self, profiles: Dict[str, ModelProfile],
                 c_gpu: float, c_cpu: float, c_disk: float,
                 hw: Optional[HardwareSpec] = None):
        self.profiles = profiles
        self.cap = {"gpu": c_gpu, "cpu": c_cpu, "disk": c_disk}
        self.hw = hw or next(iter(profiles.values())).hw if profiles else HardwareSpec()
        self.state: Dict[str, ModelState] = {
            m: ModelState.REMOTE for m in profiles}
        self.pinned: set = set()   # models that may not be evicted (in-flight)
        # LRU per tier: ordered dict model -> bytes (front = LRU)
        self.lru: Dict[str, "collections.OrderedDict[str, int]"] = {
            "gpu": collections.OrderedDict(),
            "cpu": collections.OrderedDict(),
            "disk": collections.OrderedDict(),
        }
        self.events: List[ResidencyEvent] = []

    # ------------------------------------------------------------- helpers
    def used(self, tier: str) -> int:
        return sum(self.lru[tier].values())

    def size(self, m: str) -> int:
        return self.profiles[m].weight_bytes

    def touch(self, tier: str, m: str) -> None:
        self.lru[tier][m] = self.lru[tier].pop(m, self.size(m))

    def _remove(self, tier: str, m: str) -> None:
        self.lru[tier].pop(m, None)

    # -------------------------------------------------- activation estimate
    def activation_latency(self, m: str) -> float:
        """T_act ~ sum(size/BW) over tiers to cross (+ the cold-start cost)."""
        st = self.state[m]
        size = self.size(m)
        hw = self.hw
        if st is ModelState.RUNNING:
            return 0.0
        if st is ModelState.SLEEPING:
            return size / hw.host_link_bw         # context warm: reload only
        if st is ModelState.CPU:
            return size / hw.host_link_bw + RETRACE_COST_S
        if st is ModelState.DISK:
            return size / hw.disk_bw + size / hw.host_link_bw + RETRACE_COST_S
        return (size / hw.remote_bw + size / hw.disk_bw
                + size / hw.host_link_bw + RETRACE_COST_S)

    # ------------------------------------------------------- Algorithm 1
    def ensure_gpu(self, m: str) -> Tuple[bool, float]:
        """Make model m GPU-ready; returns (success, activation seconds)."""
        size = self.size(m)
        if size > self.cap["gpu"]:
            return False, 0.0
        t_act = self.activation_latency(m)
        loc = self.state[m]
        if loc is ModelState.RUNNING:
            self.touch("gpu", m)
            return True, 0.0
        # make room on GPU (evict LRU to host, skipping pinned models)
        while self.used("gpu") + size > self.cap["gpu"]:
            victim = next((v for v in self.lru["gpu"]
                           if v not in self.pinned and v != m), None)
            if victim is None:
                return False, 0.0   # everything resident is in-flight
            self._evict_gpu_to_host(victim)
        if loc in (ModelState.DISK, ModelState.REMOTE):
            # make room in host RAM
            while self.used("cpu") + size > self.cap["cpu"]:
                v = next(iter(self.lru["cpu"]))
                self._evict_cpu(v)
            self.lru["cpu"][m] = size
            self._remove("disk", m)
            self.state[m] = ModelState.CPU
        # load to GPU (weights also stay cached in host RAM)
        self.lru["gpu"][m] = size
        self.state[m] = ModelState.RUNNING
        self.events.append(ResidencyEvent("load", m, "gpu", t_act))
        return True, t_act

    def _evict_gpu_to_host(self, m: str) -> None:
        size = self.size(m)
        self._remove("gpu", m)
        while self.used("cpu") + size > self.cap["cpu"]:
            v = next(iter(self.lru["cpu"]))
            if v == m:
                break
            self._evict_cpu(v)
        # its host copy is back: a disk copy left by _evict_cpu goes, so
        # that no model is in both the host and the disk tier
        self._remove("disk", m)
        self.lru["cpu"][m] = size
        self.state[m] = ModelState.SLEEPING
        self.events.append(ResidencyEvent(
            "evict_to_cpu", m, "cpu", size / self.hw.host_link_bw))

    def _evict_cpu(self, m: str) -> None:
        """Drop m's host copy to disk (or remote). A model that is still in
        the GPU tier keeps its state RUNNING: only its host copy went. (The
        reference marks it DISK / REMOTE while it stays resident, and then
        refuses to activate it once the card cannot hold it twice.)"""
        size = self.size(m)
        self._remove("cpu", m)
        resident = m in self.lru["gpu"]
        if self.used("disk") + size <= self.cap["disk"]:
            self.lru["disk"][m] = size
            if not resident:
                self.state[m] = ModelState.DISK
            self.events.append(ResidencyEvent(
                "evict_to_disk", m, "disk", size / self.hw.disk_bw))
        else:
            if not resident:
                self.state[m] = ModelState.REMOTE
            self.events.append(ResidencyEvent("drop", m, "remote", 0.0))

    # ----------------------------------------------------------- sleeping
    def sleep(self, m: str) -> None:
        """RUNNING -> SLEEPING (weights offloaded, warm context retained)."""
        if self.state[m] is ModelState.RUNNING:
            self._evict_gpu_to_host(m)

    def demote_context(self, m: str) -> None:
        """SLEEPING -> CPU (drop the warm device context)."""
        if self.state[m] is ModelState.SLEEPING:
            self.state[m] = ModelState.CPU

    def warm_set(self) -> List[str]:
        """Models whose device context is resident (RUNNING or SLEEPING)."""
        return [m for m, s in self.state.items()
                if s in (ModelState.RUNNING, ModelState.SLEEPING)]
