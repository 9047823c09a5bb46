"""Workflow-aware preemptive Shortest-Remaining-Time-First queueing
(§III.D, Eq. 7-8).

Global queue orders jobs by estimated remaining workflow time:
    T_rem(J,k) = T_exec(T_k) + T_future(J,k)                       (Eq. 7)
    T_future(J,k) ~ median of recent next-stage-onward times,
                    conditioned on state(J,k)                      (Eq. 8)
state(J,k) = (workflow template, agent role, invocation-index bucket,
discretized tool-intent score).

Preemption is boundary-only (between LLM invocations), guarded by hysteresis
(min predicted gain + per-job cooldown); aging raises long-waiting background
jobs to prevent starvation. Interactive stages always outrank batch ones.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np


def state_key(app: int, role: int, invocation_idx: int,
              p_tool: float) -> Tuple[int, int, int, int]:
    return (app, role, min(invocation_idx, 8),
            int(min(max(p_tool, 0.0), 0.999) * 4))  # 4 intent buckets


class WorkflowProfileStore:
    """Rolling execution profiles per workflow template (Eq. 8)."""

    def __init__(self, window: int = 128, default_future: float = 10.0):
        self.hist: Dict[Tuple, Deque[float]] = collections.defaultdict(
            lambda: collections.deque(maxlen=window))
        self.default = default_future

    def record(self, key: Tuple, future_seconds: float) -> None:
        self.hist[key].append(float(future_seconds))

    def future_median(self, key: Tuple) -> float:
        h = self.hist.get(key)
        if not h:
            # back off to coarser keys (drop intent bucket, then invocation)
            h = self.hist.get(key[:3] + (0,))
        if not h:
            return self.default
        return float(np.median(np.asarray(h)))


@dataclasses.dataclass(order=True)
class _QEntry:
    priority: float
    seq: int
    stage: object = dataclasses.field(compare=False)


@dataclasses.dataclass
class QueuedStage:
    stage_id: int
    job_id: int
    interactive: bool
    t_exec: float              # Eq. 2 estimate for the current stage
    t_future: float            # Eq. 8
    enqueue_time: float = 0.0

    @property
    def t_rem(self) -> float:
        return self.t_exec + self.t_future


class SRTFQueue:
    """Two-level queueing's GLOBAL queue: remaining-time order with class
    separation, aging, and boundary-preemption decisions."""

    def __init__(self, aging_factor: float = 0.02,
                 preempt_gain_s: float = 1.0, cooldown_s: float = 5.0):
        self.aging = aging_factor
        self.preempt_gain = preempt_gain_s
        self.cooldown = cooldown_s
        self._heap: List[_QEntry] = []
        self._seq = 0
        self._removed: set = set()
        self.last_preempt: Dict[int, float] = {}   # job -> time

    def _priority(self, s: QueuedStage, now: float) -> float:
        aged = s.t_rem - self.aging * max(0.0, now - s.enqueue_time)
        # interactive class strictly ahead of batch (mixed SLOs)
        return aged - (1e6 if s.interactive else 0.0)

    def push(self, s: QueuedStage, now: float) -> None:
        s.enqueue_time = s.enqueue_time or now
        self._seq += 1
        heapq.heappush(self._heap, _QEntry(self._priority(s, now),
                                           self._seq, s))

    def pop(self, now: float) -> Optional[QueuedStage]:
        while self._heap:
            e = heapq.heappop(self._heap)
            if id(e.stage) in self._removed:
                self._removed.discard(id(e.stage))
                continue
            return e.stage
        return None

    def peek(self) -> Optional[QueuedStage]:
        while self._heap:
            e = self._heap[0]
            if id(e.stage) in self._removed:
                heapq.heappop(self._heap)
                self._removed.discard(id(e.stage))
                continue
            return e.stage
        return None

    def refresh(self, now: float) -> None:
        """Recompute aged priorities (heap entries are stale otherwise)."""
        live = []
        while self._heap:
            e = heapq.heappop(self._heap)
            if id(e.stage) in self._removed:
                self._removed.discard(id(e.stage))
                continue
            live.append(e.stage)
        for s in live:
            self._seq += 1
            heapq.heappush(self._heap, _QEntry(self._priority(s, now),
                                               self._seq, s))

    def remove(self, s: QueuedStage) -> None:
        self._removed.add(id(s))

    def __len__(self) -> int:
        return len(self._heap) - len(self._removed)

    # --------------------------------------------------------- preemption
    def should_preempt(self, running: QueuedStage, candidate: QueuedStage,
                       running_remaining_s: float, now: float) -> bool:
        """Boundary preemption with hysteresis: only when the predicted
        latency gain exceeds the threshold and the job's cooldown expired.
        Never preempt interactive work for batch work."""
        if running.interactive and not candidate.interactive:
            return False
        gain = running_remaining_s - candidate.t_exec
        if candidate.interactive and not running.interactive:
            gain = running_remaining_s  # class override still needs cooldown
        if gain < self.preempt_gain:
            return False
        last = self.last_preempt.get(running.job_id, -1e18)
        if now - last < self.cooldown:
            return False
        self.last_preempt[running.job_id] = now
        return True
