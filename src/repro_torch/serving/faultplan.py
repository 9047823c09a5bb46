"""Deterministic fault-injection for the live serving plane.

A :class:`FaultPlan` is a scripted list of mid-run events — kill a worker,
degrade/restore a cross-cluster link, boot a replacement node — scheduled on
the gateway's own clock plane: ``FaultPlan.arm(gw)`` registers each event as
a callable payload via ``clock.call_at``, and the gateway fires it inside
``_fire_releases`` at the same boundary as transit releases. Under the
virtual clock the injection times are exact virtual seconds, so a faulted
run is as reproducible as a healthy one; under the wall clock the events
fire at real elapsed seconds and recovery rides the liveness plane
(heartbeat sweep in ``registry.py``, straggler demotion in
``distributed/fault.py``).

Recovery itself is entirely the existing machinery: a killed worker
surfaces as a typed ``WorkerDied`` -> ``_on_node_death`` -> evacuation and a
``NodeDeathEvent``; a replacement joins through ``register_node``. The plan
only decides *when* the world breaks, never *how* the gateway heals.
"""
from __future__ import annotations

import dataclasses
import os
import signal as _signal
from typing import Any, Callable, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class FaultEvent:
    """One scheduled disruption. ``at_s`` is run-relative (the plan is
    armed right after ``clock.restart()``). Subclasses implement
    ``fire(gw, now)`` and return a short human-readable outcome string for
    the plan's ``fired`` log."""
    at_s: float

    def fire(self, gw, now: float) -> str:  # pragma: no cover - interface
        raise NotImplementedError


@dataclasses.dataclass
class KillWorker(FaultEvent):
    """Kill node ``node_id`` abruptly. Worker backends with a local child
    process get a real SIGKILL (the transport EOF / heartbeat sweep then
    detects the death exactly like a production crash); remote socket
    workers (``proc is None``) get their connection torn down, which is the
    same wire-level signal. In-process runtimes have no process to kill, so
    the death is reported straight to the gateway — the virtual-clock path
    that keeps scenario sweeps deterministic."""
    node_id: int = 0

    def fire(self, gw, now: float) -> str:
        node = gw.fleet.get(self.node_id)
        if node is None:
            return f"kill node {self.node_id}: skipped (not in fleet)"
        proc = getattr(node, "proc", None)
        if proc is not None and proc.is_alive():
            os.kill(proc.pid, _signal.SIGKILL)
            return f"kill node {self.node_id}: SIGKILL pid {proc.pid}"
        conn = getattr(node, "_conn", None)
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass
            return f"kill node {self.node_id}: closed transport"
        gw._on_node_death(self.node_id, now,
                          cause="fault injection: killed")
        return f"kill node {self.node_id}: reported death (in-process)"


@dataclasses.dataclass
class DegradeLink(FaultEvent):
    """Inflate one cross-cluster link's RTT by ``factor`` (e.g. 50x models
    a congested or flapping WAN path; the fitness router sees the new cost
    on its next dispatch)."""
    src_cluster: int = 0
    dst_cluster: int = 1
    factor: float = 50.0

    def fire(self, gw, now: float) -> str:
        gw.degrade_link(self.src_cluster, self.dst_cluster, self.factor)
        return (f"degrade link {self.src_cluster}<->{self.dst_cluster} "
                f"x{self.factor:g}")


@dataclasses.dataclass
class RestoreLink(FaultEvent):
    """Return a degraded link to its nominal RTT."""
    src_cluster: int = 0
    dst_cluster: int = 1

    def fire(self, gw, now: float) -> str:
        gw.restore_link(self.src_cluster, self.dst_cluster)
        return f"restore link {self.src_cluster}<->{self.dst_cluster}"


@dataclasses.dataclass
class RegisterNode(FaultEvent):
    """Mid-run elasticity: boot a replacement (or scale-out) node and admit
    it to the serving fleet. ``factory`` builds the handle/runtime when the
    event fires — not at plan construction — so the replacement's boot cost
    lands inside the measured window, like a real autoscaler action."""
    factory: Optional[Callable[[], Any]] = None

    def fire(self, gw, now: float) -> str:
        if self.factory is None:
            return "register node: skipped (no factory)"
        nid = gw.register_node(self.factory())
        return f"register node {nid}"


@dataclasses.dataclass
class FaultPlan:
    """An ordered schedule of :class:`FaultEvent`s plus the log of what
    actually fired (``fired``: run-relative time, outcome string). Pass it
    to ``ClusterGateway.run(jobs, fault_plan=plan)``; a plan can be armed
    once per run."""
    events: Sequence[FaultEvent] = ()

    def __post_init__(self):
        self.fired: List[Tuple[float, str]] = []
        self._armed = False

    def arm(self, gw) -> None:
        if self._armed:
            raise RuntimeError("FaultPlan already armed — plans are "
                               "single-use (the fired log is per-run)")
        self._armed = True
        base = gw.clock.now()
        for ev in sorted(self.events, key=lambda e: e.at_s):
            self._schedule(gw, ev, base + ev.at_s)

    def _schedule(self, gw, ev: FaultEvent, release_t: float) -> None:
        def payload(now: float, _ev=ev):
            self.fired.append((now, _ev.fire(gw, now)))
        gw.clock.call_at(release_t, payload)
