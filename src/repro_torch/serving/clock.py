"""The clock plane: pluggable time/event machinery for the live gateway.

Before this module existed, time was smeared across ``ClusterGateway`` — a
tick counter, ``tick_s`` arithmetic in ``now``/``t_exec_est``/``_deadline``,
refresh cadences counted in ticks, RTT/T_act modelled as per-tick scans over
in-flight records, and a magic ``max_ticks`` heuristic in ``run()``. This
module extracts all of it behind one :class:`Clock` protocol with two
implementations:

- :class:`VirtualClock` — the deterministic step-driven clock every test and
  cross-PR BENCH baseline depends on. One ``advance()`` is one tick of
  ``tick_s`` virtual seconds; delayed events (RTT + activation transit)
  release on the first tick at/after their due time, **in schedule order**
  within a tick — exactly reproducing the old insertion-ordered
  ``_flush_submissions`` scan, so virtual runs stay bit-identical to the
  pre-refactor gateway on both node backends.
- :class:`WallClock` — real monotonic time. Events release when wall time
  passes them (release order), ``advance()`` sleeps until the next known
  wake-up (arrival, event release, or a short poll interval while work is in
  flight), and queue delay / SLO attainment are measured in real elapsed
  seconds. Under this clock the worker fleet free-runs: engine iterations
  genuinely overlap across processes in *measured* time.

Both clocks enforce the run deadline (``GatewayConfig.max_run_s``): the
gateway loop asks ``expired()`` instead of counting ticks, and a run cut
short reports a typed :class:`RunDeadlineExceeded` outcome in its metrics
instead of silently truncating.

Periodic work (aging refresh, telemetry sampling) goes through
``Clock.cadence(period_s)``: the virtual clock converts the period to a
whole number of ticks and fires on the tick modulus (bit-identical to the
old ``tick % every == 0`` checks), the wall clock fires whenever real time
passes the next due point. Periods are expressed in SECONDS everywhere, so
policy hysteresis and cadences are clock-independent.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Any, Callable, List, Optional, Protocol, runtime_checkable

#: Slack applied when deciding an event is due on the virtual clock — the
#: same epsilon the old per-tick ``submit_at > now + 1e-9`` scan used.
EPS = 1e-9

#: Hard cap on a single wall-clock sleep: even with a far-off wake-up the
#: loop re-checks at least this often (arrivals can't starve the deadline).
MAX_WALL_SLEEP_S = 0.1


@dataclasses.dataclass(frozen=True)
class RunDeadlineExceeded:
    """Typed run outcome: the clock's run deadline fired before every job
    finished. Recorded in ``GatewayMetrics.run_deadline`` (and mirrored by
    ``run_outcome == "deadline_exceeded"``) instead of the pre-clock-plane
    behavior of silently returning truncated metrics."""
    max_run_s: float              # the deadline that fired (clock seconds)
    elapsed_s: float              # clock time when the run stopped
    unfinished_jobs: int          # jobs neither finished nor dropped


class Cadence(Protocol):
    """Periodic trigger bound to one clock; ``due()`` is polled once per
    gateway loop iteration."""

    def due(self) -> bool: ...


@runtime_checkable
class Clock(Protocol):
    """What the gateway's event-driven core needs from time.

    ``call_at`` schedules a delayed release (RTT / cold-start transit);
    ``pop_due`` returns every released payload; ``advance`` moves time
    forward (one tick, or a real sleep until ``until``); ``expired`` is the
    run-deadline guard. ``name`` tags telemetry rows ("virtual" / "wall").
    """

    name: str

    def now(self) -> float: ...

    def call_at(self, t: float, payload: Any) -> None: ...

    def pop_due(self) -> List[Any]: ...

    def peek_next(self) -> Optional[float]: ...

    def advance(self, until: Optional[float] = None) -> None: ...

    def restart(self) -> None: ...

    def set_deadline(self, max_run_s: Optional[float]) -> None: ...

    def expired(self) -> bool: ...

    def cadence(self, period_s: float) -> Cadence: ...


class _TickCadence:
    """Virtual cadence: fires when the tick counter hits the modulus —
    bit-identical to the old ``tick % every == 0`` gateway checks (fires at
    tick 0, then every ``every_ticks``)."""

    def __init__(self, clock: "VirtualClock", every_ticks: int):
        self._clock = clock
        self._every = max(1, int(every_ticks))

    def due(self) -> bool:
        return self._clock._tick % self._every == 0


class _WallCadence:
    """Wall cadence: fires whenever real time reaches the next due point
    (first call always fires, mirroring the tick-0 virtual behavior)."""

    def __init__(self, clock: "WallClock", period_s: float):
        self._clock = clock
        self._period = max(float(period_s), 0.0)
        self._next = clock.now()

    def due(self) -> bool:
        now = self._clock.now()
        if now + EPS >= self._next:
            self._next = now + self._period
            return True
        return False


class VirtualClock:
    """Deterministic step-driven clock: integer ticks of ``tick_s`` seconds.

    Event releases within one tick come back in SCHEDULE order (not release
    order): the pre-refactor gateway submitted transit-delayed stages by
    scanning its in-flight dict in insertion order every tick, so two events
    due in the same tick must fire in the order they were scheduled for runs
    to stay bit-identical.

    The run deadline can be set in seconds (``set_deadline``) or — for the
    deprecated ``max_ticks`` call path — in exact ticks
    (``set_deadline_ticks``), so legacy callers keep their precise cutoff.
    """

    name = "virtual"

    def __init__(self, tick_s: float = 0.05):
        self.tick_s = float(tick_s)
        self._tick = 0
        self._heap: List[tuple] = []          # (release_t, seq, payload)
        self._seq = 0
        self._max_tick: Optional[int] = None

    # ------------------------------------------------------------------ time
    def now(self) -> float:
        return self._tick * self.tick_s

    @property
    def tick(self) -> int:
        return self._tick

    def advance(self, until: Optional[float] = None) -> None:
        # virtual time is oblivious to wake-up hints: one advance = one tick
        self._tick += 1

    def restart(self) -> None:
        """No-op: virtual time is already workload-relative (tick 0 is the
        start of the run, not of clock construction)."""

    # ---------------------------------------------------------------- events
    def call_at(self, t: float, payload: Any) -> None:
        self._seq += 1
        heapq.heappush(self._heap, (float(t), self._seq, payload))

    def peek_next(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def pop_due(self) -> List[Any]:
        now = self.now()
        due: List[tuple] = []
        while self._heap and self._heap[0][0] <= now + EPS:
            due.append(heapq.heappop(self._heap))
        # schedule order within the tick (see class docstring)
        due.sort(key=lambda e: e[1])
        return [payload for _, _, payload in due]

    # -------------------------------------------------------------- deadline
    def set_deadline(self, max_run_s: Optional[float]) -> None:
        self._max_tick = (None if max_run_s is None
                          else int(round(max_run_s / self.tick_s)))

    def set_deadline_ticks(self, max_ticks: Optional[int]) -> None:
        self._max_tick = None if max_ticks is None else int(max_ticks)

    @property
    def deadline_s(self) -> Optional[float]:
        return (None if self._max_tick is None
                else self._max_tick * self.tick_s)

    def expired(self) -> bool:
        return self._max_tick is not None and self._tick >= self._max_tick

    # --------------------------------------------------------------- cadence
    def cadence(self, period_s: float) -> Cadence:
        return _TickCadence(self, round(float(period_s) / self.tick_s))


class WallClock:
    """Real monotonic time. ``now()`` is seconds since construction;
    ``advance(until)`` sleeps until the requested wake-up (capped at
    :data:`MAX_WALL_SLEEP_S` so deadlines and arrivals are never starved);
    events release when wall time passes them, in release order.

    ``time_fn``/``sleep_fn`` are injectable for deterministic unit tests.
    """

    name = "wall"

    def __init__(self, time_fn: Callable[[], float] = time.monotonic,
                 sleep_fn: Callable[[float], None] = time.sleep):
        self._time = time_fn
        self._sleep = sleep_fn
        self._t0 = self._time()
        self._heap: List[tuple] = []
        self._seq = 0
        self._deadline: Optional[float] = None

    # ------------------------------------------------------------------ time
    def now(self) -> float:
        return self._time() - self._t0

    def advance(self, until: Optional[float] = None) -> None:
        if until is None:
            return                 # caller did real work this pass: free-run
        delay = until - self.now()
        if delay > 0:
            self._sleep(min(delay, MAX_WALL_SLEEP_S))

    def restart(self) -> None:
        """Re-zero the epoch: wall time restarts at 0 NOW. The gateway
        calls this when a run begins, so pre-run work (fleet warmup, JIT
        compilation) is never billed to the measured serving window.
        Events still pending (e.g. stages left in transit when a previous
        run hit its deadline) keep their REMAINING delay: their release
        times are rebased onto the new epoch."""
        offset = self.now()
        if self._heap:
            self._heap = [(max(0.0, t - offset), seq, payload)
                          for t, seq, payload in self._heap]
            heapq.heapify(self._heap)
        self._t0 = self._time()

    # ---------------------------------------------------------------- events
    def call_at(self, t: float, payload: Any) -> None:
        self._seq += 1
        heapq.heappush(self._heap, (float(t), self._seq, payload))

    def peek_next(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def pop_due(self) -> List[Any]:
        now = self.now()
        due: List[Any] = []
        while self._heap and self._heap[0][0] <= now:
            due.append(heapq.heappop(self._heap)[2])
        return due

    # -------------------------------------------------------------- deadline
    def set_deadline(self, max_run_s: Optional[float]) -> None:
        self._deadline = None if max_run_s is None else float(max_run_s)

    @property
    def deadline_s(self) -> Optional[float]:
        return self._deadline

    def expired(self) -> bool:
        return self._deadline is not None and self.now() >= self._deadline

    # --------------------------------------------------------------- cadence
    def cadence(self, period_s: float) -> Cadence:
        return _WallCadence(self, period_s)


def make_clock(mode: str, tick_s: float) -> Clock:
    """Clock factory for ``GatewayConfig.clock`` ("virtual" | "wall")."""
    if mode == "virtual":
        return VirtualClock(tick_s=tick_s)
    if mode == "wall":
        return WallClock()
    raise ValueError(f"unknown clock mode {mode!r} "
                     "(expected 'virtual' or 'wall')")
