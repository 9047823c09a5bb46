"""Fleet membership plane: liveness tracking the gateway owns.

The gateway's view of its worker fleet was static — the fleet it was built
with, assumed alive forever. :class:`FleetRegistry` makes membership a
first-class, time-varying fact:

- **Heartbeats are piggybacked, not extra traffic.** Any consumed reply
  (poll reports, submit acks, step replies) proves the worker alive, so
  the gateway records a beat whenever a node's reply counter advanced
  since the last membership sweep. Only a node that was *silent* for a
  whole sweep gets an explicit idle-period ping
  (``NodeHandle.ping_send``) — busy fleets pay zero extra round trips.
- **Liveness state machine**: ``healthy -> suspect -> dead`` on heartbeat
  age (configurable timeouts), with recovery ``suspect -> healthy`` on any
  fresh beat. A node the :class:`~repro_torch.distributed.fault.StragglerDetector`
  flags (its EWMA step time is a z-score outlier against the fleet) is
  demoted to ``suspect`` even while its heartbeats are current — slow is
  the precursor of dead, and ``suspect`` is the signal an external
  autoscaler (or ElasticController policy) keys on.
- **Death is decided here, handled by the gateway**: transport EOF
  (``WorkerDied``) or heartbeat timeout marks the member ``dead``; the
  gateway then evacuates — in-flight stages re-enter the ready queue as
  not-yet-dispatched, per-node prefix/reservation state is written off,
  and the death lands in telemetry as a typed ``NodeDeathEvent``.
- **Elastic membership**: ``register``/``retire`` admit and drain nodes
  mid-run, so a wall-clock fleet can grow and shrink under load.

Timeouts are denominated in *gateway clock* seconds and the sweep runs
only under the wall clock (virtual time advances while workers compute in
real time, so any virtual-time liveness deadline would be meaningless and
break the bit-identical parity contract). Under the virtual clock the only
death signal is transport EOF — which is also the only one that can
actually fire there.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.distributed.fault import StragglerDetector

HEALTHY = "healthy"
SUSPECT = "suspect"
DEAD = "dead"
RETIRED = "retired"


@dataclasses.dataclass
class HeartbeatConfig:
    """Membership timing knobs (gateway-clock seconds)."""
    #: membership sweep cadence; also how often a silent node is pinged
    interval_s: float = 0.25
    #: heartbeat age that demotes healthy -> suspect
    suspect_after_s: float = 1.0
    #: heartbeat age that declares a member dead (evacuation follows)
    dead_after_s: float = 5.0

    def __post_init__(self):
        if not (0 < self.interval_s <= self.suspect_after_s
                <= self.dead_after_s):
            raise ValueError(
                f"need 0 < interval_s <= suspect_after_s <= dead_after_s, "
                f"got {self.interval_s}/{self.suspect_after_s}/"
                f"{self.dead_after_s}")


@dataclasses.dataclass
class MemberRecord:
    """One node's membership history."""
    node_id: int
    joined_t: float
    state: str = HEALTHY
    last_beat_t: float = 0.0
    beats: int = 0
    suspect_since: Optional[float] = None
    suspect_cause: str = ""
    died_t: Optional[float] = None
    death_cause: str = ""
    #: how many members have held this node id (1 = original; each
    #: re-registration after a death — a replacement worker reusing the
    #: id — increments it, so fault-injection suites can tell a rejoined
    #: fleet from one that never broke)
    generation: int = 1


class FleetRegistry:
    """Liveness bookkeeping for the gateway's worker fleet. Pure state
    machine over explicit ``now`` values — no clock of its own, so it is
    equally testable under virtual and wall time."""

    def __init__(self, cfg: Optional[HeartbeatConfig] = None,
                 detector: Optional[StragglerDetector] = None):
        self.cfg = cfg or HeartbeatConfig()
        self.detector = detector
        self.members: Dict[int, MemberRecord] = {}
        #: node ids in death order (a node re-registered after dying — a
        #: replacement reusing the id — can appear more than once)
        self.deaths: List[int] = []
        #: post-death re-registrations (replacement workers), in join order
        self.rejoins: List[int] = []

    # ---------------------------------------------------------- membership
    def register(self, node_id: int, now: float) -> MemberRecord:
        """Admit a node (fleet construction or mid-run elasticity). A dead
        member's id may be re-registered — that is reconnect: a replacement
        worker joining under the same node id, tracked as a new generation
        of the member."""
        prev = self.members.get(node_id)
        rec = MemberRecord(node_id=node_id, joined_t=now, last_beat_t=now)
        if prev is not None:
            rec.generation = prev.generation + 1
            if prev.state == DEAD:
                self.rejoins.append(node_id)
        self.members[node_id] = rec
        return rec

    def retire(self, node_id: int, now: float) -> None:
        """Graceful drain: the node leaves the fleet without a death event."""
        rec = self.members.get(node_id)
        if rec is not None and rec.state != DEAD:
            rec.state = RETIRED
        if self.detector is not None:
            self.detector.forget(node_id)

    def mark_dead(self, node_id: int, now: float,
                  cause: str = "transport failure") -> None:
        """Declare a member dead (transport EOF or timeout sweep)."""
        rec = self.members.get(node_id)
        if rec is None or rec.state in (DEAD, RETIRED):
            return
        rec.state = DEAD
        rec.died_t = now
        rec.death_cause = cause
        self.deaths.append(node_id)
        if self.detector is not None:
            self.detector.forget(node_id)

    # ------------------------------------------------------------ liveness
    def beat(self, node_id: int, now: float) -> None:
        """Record proof of life (a consumed reply or ping ack)."""
        rec = self.members.get(node_id)
        if rec is None or rec.state in (DEAD, RETIRED):
            return
        rec.last_beat_t = now
        rec.beats += 1

    def observe_step(self, node_id: int, step_s: float) -> None:
        """Feed one wall-clock engine-step observation to the straggler
        detector (per-node ``worker_step_wall_s`` deltas)."""
        if self.detector is not None and step_s > 0:
            self.detector.observe(node_id, step_s)

    def update(self, now: float) -> List[int]:
        """One membership sweep: age heartbeats through the state machine
        and fold in straggler demotions. Returns node ids newly declared
        dead by timeout (the caller evacuates them)."""
        slow = (set(self.detector.stragglers())
                if self.detector is not None else set())
        newly_dead: List[int] = []
        for nid, rec in self.members.items():
            if rec.state in (DEAD, RETIRED):
                continue
            age = now - rec.last_beat_t
            if age >= self.cfg.dead_after_s:
                self.mark_dead(
                    nid, now,
                    cause=f"heartbeat timeout ({age:.2f}s silent)")
                newly_dead.append(nid)
            elif age >= self.cfg.suspect_after_s or nid in slow:
                if rec.state != SUSPECT:
                    rec.state = SUSPECT
                    rec.suspect_since = now
                    rec.suspect_cause = ("straggler" if nid in slow
                                         else f"heartbeat age {age:.2f}s")
            elif rec.state == SUSPECT:
                rec.state = HEALTHY        # fresh beat + not slow: recover
                rec.suspect_since = None
                rec.suspect_cause = ""
        return newly_dead

    # ------------------------------------------------------------- queries
    def state(self, node_id: int) -> str:
        return self.members[node_id].state

    def states(self) -> Dict[int, str]:
        return {nid: rec.state for nid, rec in sorted(self.members.items())}

    def live(self) -> List[int]:
        return [nid for nid, rec in sorted(self.members.items())
                if rec.state in (HEALTHY, SUSPECT)]

    def suspects(self) -> List[int]:
        return [nid for nid, rec in sorted(self.members.items())
                if rec.state == SUSPECT]

    def stragglers(self) -> List[int]:
        """Live nodes the detector currently flags (wall clock only — the
        observations are real seconds)."""
        if self.detector is None:
            return []
        alive = {nid for nid, rec in self.members.items()
                 if rec.state in (HEALTHY, SUSPECT)}
        return sorted(n for n in self.detector.stragglers() if n in alive)
