"""Multi-process node runtimes: one OS process per ``NodeRuntime``; the
port's copy of ``repro/serving/worker.py``.

The in-process gateway cooperatively steps every node inside its own
interpreter, so cross-node overlap is emulated, not real. This module moves
each node into a child process and gives the gateway a :class:`NodeHandle`
proxy that speaks a small request/reply protocol over ``multiprocessing``
pipes — submit / step / poll-finished / make_room / signal snapshots plus
the admission and routing estimates the Substrate protocol needs. The
handle implements the exact node-facing surface ``ClusterGateway`` consumes
(``signal`` / ``can_admit`` / ``t_act`` / ``degradation_cost`` / ``submit``
/ ``preempt`` / ``step`` / ``acc.headroom`` / ``kv_stats``), so the
gateway's dispatch change is a thin backend switch, not a rewrite.

Design points:

- Children are SPAWNED (never forked: a forked child cannot initialise
  CUDA): each worker imports torch fresh and builds its own model zoo +
  ``NodeRuntime`` on its own device from a picklable :class:`WorkerSpec`;
  tensors never cross the pipe. Only plain data does (``Request``
  objects, ``NodeSignal`` snapshots, float estimates, the ``records``
  dict).
- ``step`` replies carry (finished requests, per-request decode progress,
  measured worker wall-clock). Progress lets the gateway's boundary
  preemption rank victims exactly as it does in-process, where it can read
  ``req.out`` directly.
- The handle counts every round trip (``ipc_calls``, ``ipc_wall_s``) and
  accumulates the worker-reported step wall-clock (``worker_step_wall_s``)
  — the per-node IPC-overhead counters surfaced through gateway telemetry.
- Wall-clock free-run (``set_continuous``): under the gateway's wall clock
  a child steps its own engines whenever they hold work, buffering finished
  requests for the next ``poll_finished`` round trip — engine iterations
  genuinely overlap across processes in *measured* time, with pipe requests
  still serviced at every engine-step boundary (so preemption/admission
  stay boundary-consistent). Virtual runs never enable this mode.
- Determinism: the protocol is synchronous request/reply per node, and the
  gateway collects step replies in node order, so a "process" run under the
  deterministic virtual clock reproduces the in-process completion sets and
  metrics bit-for-bit (see ``tests/test_torch_worker.py``). Scope of that
  guarantee: it holds for every policy in the registry, none of which reads
  node state from ``priority``/``on_finish``. A custom policy that makes a
  node read (e.g. ``sub.signal``) while the gateway is draining the tick's
  step replies observes POST-step state here (the worker already executed
  the broadcast step) but pre-step state in-process — that window is the
  price of real concurrency; keep node reads inside ``route``/``reservation``
  (which run before the broadcast) to stay backend-identical.
- Records (``NodeHandle.records``): the child's kernel launch counts are
  module globals of its own process, so the parent reads them, with the
  node's activations and offloads, its device's peak memory and the
  modules it loaded, through one more method of the protocol.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import multiprocessing as mp
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import foreign_modules
from repro_torch.kernels import ops
from repro_torch.serving import transport
from repro_torch.serving.engine import PromptTooLongError, Request

_SHUTDOWN_TIMEOUT_S = 5.0
# free-running children with idle engines block on the pipe this long per
# loop pass instead of spinning (wall-clock continuous mode only)
_IDLE_POLL_S = 0.005
# how long a locally spawned socket child may take to bind + report its port
# (it reports before it builds its node: process startup and imports only)
_BOOT_TIMEOUT_S = 60.0
#: method-surface version carried in the socket hello handshake — bumped
#: when the request/reply method set changes (the frame format has its own
#: independent version, ``transport.FRAME_VERSION``)
PROTOCOL_VERSION = 1


class WorkerDied(RuntimeError):
    """A worker's transport failed mid-protocol: the process was killed
    (OOM/segfault/SIGKILL) or the socket peer vanished. Carries the node id
    so the gateway's membership plane can evacuate exactly that node."""

    def __init__(self, node_id: int, msg: str):
        super().__init__(msg)
        self.node_id = node_id


@dataclasses.dataclass
class WorkerSpec:
    """Everything a child needs to rebuild its node — plain picklable data.

    The child constructs its own zoo/host trees from ``model_names`` +
    ``seed`` (same deterministic init path as ``cluster.build_zoo``), so a
    worker node is numerically identical to the in-process node the same
    spec would build. ``device``: the node's device, ``cuda`` when None.
    ``reduced=False`` builds the full-width configs, their weights drawn
    on the device and kept in one pinned host copy per model, which the
    node takes as its host tier; ``n_layers`` (model name, layers) pairs
    cut those configs in depth."""
    node_id: int
    cluster_id: int
    model_names: Tuple[str, ...]
    # None = use NodeRuntime's own defaults, so the two backends cannot
    # silently drift if those defaults change
    hbm_budget: Optional[float] = None
    max_slots: Optional[int] = None
    s_max: Optional[int] = None
    ctx_bytes: Optional[int] = None
    page_tokens: Optional[int] = None
    prefix_cache: Optional[bool] = None
    prefix_cache_pages: Optional[int] = None
    # engine iteration-scheduler knobs (None = NodeRuntime defaults):
    # max_batch_tokens caps decode positions + prefill chunk tokens per
    # fused iteration; prefill_chunk_tokens > 0 enables chunked prefill
    max_batch_tokens: Optional[int] = None
    prefill_chunk_tokens: Optional[int] = None
    # decode_horizon > 1 fuses that many decode iterations per host sync
    decode_horizon: Optional[int] = None
    seed: int = 1
    device: Optional[str] = None
    reduced: bool = True
    n_layers: Optional[Tuple[Tuple[str, int], ...]] = None


def _worker_main(conn, spec: WorkerSpec) -> None:
    """Child entry point: build the runtime, then serve the request loop.

    Heavy imports happen here, inside the spawned interpreter — the parent
    never ships device state. Every post-boot reply is ``(kind, payload,
    compute_wall_s)`` with kind in {"ok", "prompt_too_long", "err"};
    ``compute_wall_s`` is the child-measured time spent executing the
    method, so the parent can charge only the residual (pipe + pickle) to
    its IPC-overhead counter. Boot replies are ``("ready"|"boot_error",
    payload)``."""
    try:
        from repro_torch.serving.cluster import build_zoo
        from repro_torch.serving.node_runtime import NodeRuntime
        zoo, host = build_zoo(spec.model_names, seed=spec.seed,
                              reduced=spec.reduced, device=spec.device,
                              n_layers=dict(spec.n_layers or ()))
        kw = {k: v for k, v in (("hbm_budget", spec.hbm_budget),
                                ("max_slots", spec.max_slots),
                                ("s_max", spec.s_max),
                                ("ctx_bytes", spec.ctx_bytes),
                                ("page_tokens", spec.page_tokens),
                                ("prefix_cache", spec.prefix_cache),
                                ("prefix_cache_pages",
                                 spec.prefix_cache_pages),
                                ("max_batch_tokens", spec.max_batch_tokens),
                                ("prefill_chunk_tokens",
                                 spec.prefill_chunk_tokens),
                                ("decode_horizon", spec.decode_horizon),
                                ("device", spec.device))
              if v is not None}
        node = NodeRuntime(spec.node_id, spec.cluster_id, zoo, host, **kw)
        conn.send(("ready", {"profiles": node.profiles,
                             "max_slots": node.max_slots,
                             "s_max": node.s_max}))
    except Exception:
        conn.send(("boot_error", traceback.format_exc()))
        return
    # wall-clock free-running mode (set via the "continuous" method): the
    # child steps its engines whenever they hold work, buffering finished
    # requests for the gateway's next "poll", and services pipe requests
    # with priority at every engine-step boundary. The default (continuous
    # off) is the original strict request/reply loop, untouched — virtual
    # runs stay bit-identical.
    continuous = False
    buffered: Dict[str, List[Request]] = {}
    buffered_wall = 0.0
    while True:
        if continuous:
            has_work = node.has_work()
            try:
                ready = conn.poll(0.0 if has_work else _IDLE_POLL_S)
            except (EOFError, OSError):
                break
            if not ready:
                if has_work:
                    t0 = time.perf_counter()
                    out = node.step()
                    for eng in node.engines.values():
                        if eng.waiting and eng.free_slots:
                            # admission blocked on memory, not slots: the
                            # gateway admitted against a boundary-stale
                            # headroom report, so reclaim locally (Alg. 2
                            # cheap prefix; no-op when headroom suffices)
                            # instead of waiting for a release that may
                            # never come
                            node.make_room(eng._r_need(eng.waiting[0]))
                    buffered_wall += time.perf_counter() - t0
                    for m, reqs in out.items():
                        buffered.setdefault(m, []).extend(reqs)
                continue
        try:
            method, args = conn.recv()
        except (EOFError, OSError, KeyboardInterrupt):
            break
        if method == "shutdown":
            conn.send(("ok", None, 0.0))
            break
        t0 = time.perf_counter()
        try:
            if method == "step":
                out = node.step()
                progress = {rid: len(r.out)
                            for eng in node.engines.values()
                            for rid, r in eng.active.items()}
                payload = (out, progress)
            elif method == "continuous":
                continuous = bool(args[0])
                payload = None
            elif method == "poll":
                # drain the free-run buffer: finished requests by model,
                # current decode progress, the engine-step wall clock
                # accumulated since the last poll, and a fresh NodeSignal —
                # the periodic node->scheduler report of §III that lets the
                # wall-clock gateway route/admit WITHOUT a synchronous
                # round trip per decision (each one blocks until the next
                # engine-step boundary)
                progress = {rid: len(r.out)
                            for eng in node.engines.values()
                            for rid, r in eng.active.items()}
                payload = (buffered, progress, buffered_wall,
                           node.signal())
                buffered, buffered_wall = {}, 0.0
            elif method == "ping":
                # idle-period liveness probe from the membership plane: a
                # no-op round trip whose reply is the heartbeat
                payload = None
            elif method == "headroom":
                payload = node.acc.headroom
            elif method == "acc_can_admit":
                payload = node.acc.can_admit(*args)
            elif method == "records":
                payload = _records(node)
            elif method == "reset_records":
                payload = _reset_records(node)
            else:
                # signal / can_admit / t_act / degradation_cost / make_room
                # / submit / preempt / activate / sleep / kv_stats
                payload = getattr(node, method)(*args)
            conn.send(("ok", payload, time.perf_counter() - t0))
        except PromptTooLongError as e:
            conn.send(("prompt_too_long", str(e),
                       time.perf_counter() - t0))
        except Exception:
            conn.send(("err", traceback.format_exc(),
                       time.perf_counter() - t0))


def _records(node) -> Dict[str, Any]:
    """The child's records as plain data: the node's activations and
    offloads, the kernels' launches by kernel and by variant and the plain
    versions' calls since the last reset, the peak allocated and the
    reserved bytes of the node's device (None off CUDA), and the modules of
    JAX or of the JAX package ``repro`` loaded in this process."""
    on_card = node.device.type == "cuda"
    return {"activations": [dataclasses.asdict(a) for a in node.activations],
            "offloads": [dataclasses.asdict(o) for o in node.offloads],
            **ops.counts(),
            "max_memory_allocated": (
                int(torch.cuda.max_memory_allocated(node.device))
                if on_card else None),
            "memory_reserved": (int(torch.cuda.memory_reserved(node.device))
                                if on_card else None),
            "foreign_modules": foreign_modules()}


def _reset_records(node) -> None:
    """Zero the launch and plain-call counts and the device's peak."""
    ops.reset_counts()
    if node.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(node.device)


class _AccProxy:
    """The two accountant reads the gateway makes (`headroom` for telemetry
    sampling, `can_admit` for the submit-time make_room check), forwarded to
    the worker's real ``MemoryAccountant``."""

    def __init__(self, handle: "NodeHandle"):
        self._h = handle

    @property
    def headroom(self) -> float:
        return self._h._call("headroom")

    def can_admit(self, r_need: float) -> bool:
        return self._h._call("acc_can_admit", r_need)


class NodeHandle:
    """Gateway-side proxy for one worker process hosting a ``NodeRuntime``.

    Synchronous surface mirrors the runtime 1:1; ``step_send``/``step_recv``
    split the step round trip so the gateway can broadcast one tick to every
    worker and let the engine iterations genuinely overlap across processes
    before collecting replies in deterministic node order."""

    backend = "process"

    def __init__(self, spec: WorkerSpec, ctx=None):
        ctx = ctx or mp.get_context("spawn")
        self._init_state(spec)
        self._conn, child = ctx.Pipe()
        self.proc = ctx.Process(target=_worker_main, args=(child, spec),
                                name=f"maestro-node-{spec.node_id}",
                                daemon=True)
        try:
            self.proc.start()
        except Exception:
            self.close()
            raise
        child.close()

    def _init_state(self, spec: WorkerSpec) -> None:
        """Transport-independent handle state; set FIRST so ``close`` is
        safe on a handle whose transport setup failed halfway."""
        self.spec = spec
        self.node_id = spec.node_id
        self.cluster_id = spec.cluster_id
        self._closed = False
        self._ready = False
        # IPC-overhead + worker wall-clock counters (gateway telemetry)
        self.ipc_calls = 0
        self.ipc_wall_s = 0.0
        self.worker_step_wall_s = 0.0
        # idle-period pings still unanswered when the next came due
        # (membership plane; see ping_send)
        self.heartbeat_misses = 0
        self.acc = _AccProxy(self)
        self.profiles: Dict[str, Any] = {}
        self.max_slots = spec.max_slots
        self.s_max = spec.s_max
        # prompt page granularity, for gateway-side digest computation
        # (must match NodeRuntime's page_tokens default)
        self.page_tokens = spec.page_tokens or 16
        self._inflight = 0            # submitted minus finished/preempted
        self._progress: Dict[int, int] = {}
        self._step_pending = False
        self._step_buffer: Optional[Dict[str, List[Request]]] = None
        # wall-clock free-run bookkeeping: the pipe is FIFO, so every
        # outstanding request's reply arrives in send order — `_expected`
        # records what each upcoming reply is (("poll",) / ("submit", rid)
        # / ("ping",) / ("sync", method)) and replies are folded into
        # handle state as they are consumed
        self._expected: collections.deque = collections.deque()
        self._finished_buf: Dict[str, List[Request]] = {}
        self._submit_errors: List[int] = []
        self._poll_pending = False
        self._ping_pending = False
        self._cached_signal = None    # last NodeSignal piggybacked on a poll

    # ------------------------------------------------------------- lifecycle
    def wait_ready(self) -> "NodeHandle":
        """Block until the child built its runtime (spawn boots in parallel
        across a fleet: start all handles first, then wait on each)."""
        if self._ready:
            return self
        try:
            kind, payload = self._conn.recv()
        except (EOFError, OSError):
            self.close()
            raise WorkerDied(
                self.node_id,
                f"node {self.node_id} worker died during boot "
                f"({self._exit_status()}); note: spawn re-imports "
                f"the parent __main__, which must be an importable file")
        if kind != "ready":
            self.close()
            raise RuntimeError(
                f"node {self.node_id} worker failed to boot:\n{payload}")
        self.profiles = payload["profiles"]
        self.max_slots = payload["max_slots"]
        self.s_max = payload["s_max"]
        self._ready = True
        return self

    def _exit_status(self) -> str:
        proc = getattr(self, "proc", None)
        if proc is not None:
            return f"exitcode={proc.exitcode}"
        return f"remote worker at {getattr(self, 'address', None)}"

    def close(self) -> None:
        """Idempotent shutdown, safe on half-constructed handles (partial
        fleet spawn) and on remote handles that own no local process."""
        if getattr(self, "_closed", False):
            return
        self._closed = True
        conn = getattr(self, "_conn", None)
        proc = getattr(self, "proc", None)
        peer_up = proc.is_alive() if proc is not None else conn is not None
        if peer_up and conn is not None:
            try:
                conn.send(("shutdown", ()))
                if conn.poll(_SHUTDOWN_TIMEOUT_S):
                    conn.recv()
            except (BrokenPipeError, EOFError, OSError):
                pass
        if proc is not None and getattr(proc, "_popen", None) is not None:
            # (guard: join on a never-started Process raises)
            proc.join(timeout=_SHUTDOWN_TIMEOUT_S)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=_SHUTDOWN_TIMEOUT_S)
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass

    def __del__(self):  # best-effort: never leak a worker
        try:
            proc = getattr(self, "proc", None)
            if proc is not None and proc.is_alive():
                proc.terminate()
        except Exception:
            pass

    # -------------------------------------------------------------- protocol
    def _call(self, method: str, *args):
        self.wait_ready()
        if self._step_pending:
            # a synchronous call while a step reply is in flight (e.g. a
            # custom policy reading signal() from an on_finish hook): collect
            # and buffer the step payload first so replies cannot mis-pair
            self._step_buffer = self._recv_step()
        t0 = time.perf_counter()
        self._send(method, args)
        self._expected.append(("sync", method))
        # asynchronous replies queued ahead of ours (armed polls, async
        # submits — the pipe is FIFO and the child drains every pending
        # request at one engine-step boundary) are folded into handle state
        # on the way to our reply: one boundary wait covers them all
        while True:
            tag = self._expected.popleft()
            if tag[0] != "sync":
                self._fold_async(tag)
                continue
            kind, payload, compute_wall = self._recv(method)
            self.ipc_calls += 1
            # only the residual over the child-measured method execution is
            # IPC overhead — a submit that pays a real activation
            # (device_put of weights) must not read as pipe/pickle cost
            self.ipc_wall_s += max(0.0,
                                   time.perf_counter() - t0 - compute_wall)
            if kind == "prompt_too_long":
                raise PromptTooLongError(payload)
            if kind != "ok":
                raise RuntimeError(
                    f"node {self.node_id} worker error in "
                    f"{method}:\n{payload}")
            return payload

    def _fold_async(self, tag) -> None:
        """Receive ONE asynchronous reply and fold it into handle state.
        The pipe is FIFO, so ``tag`` (the head of ``_expected``) is what
        this reply must be."""
        kind, payload, _ = self._recv(tag[0])
        self.ipc_calls += 1
        if tag[0] == "poll":
            self._poll_pending = False
            if kind != "ok":
                raise RuntimeError(
                    f"node {self.node_id} worker error in poll:\n{payload}")
            out, progress, step_wall, self._cached_signal = payload
            self.worker_step_wall_s += step_wall
            self._progress = progress
            for model, reqs in out.items():
                self._finished_buf.setdefault(model, []).extend(reqs)
                self._inflight -= len(reqs)
        elif tag[0] == "submit":
            if kind == "prompt_too_long":
                # typed rejection of an async submit: surfaced to the
                # gateway via take_submit_errors (the stage finishes
                # truncated, exactly like the synchronous path)
                self._inflight -= 1
                self._submit_errors.append(tag[1])
            elif kind != "ok":
                raise RuntimeError(
                    f"node {self.node_id} worker error in async "
                    f"submit:\n{payload}")
        elif tag[0] == "ping":
            self._ping_pending = False
            if kind != "ok":                     # pragma: no cover
                raise RuntimeError(
                    f"node {self.node_id} worker error in ping:\n{payload}")
        else:                                    # pragma: no cover
            raise AssertionError(f"unknown async reply tag {tag!r}")

    # -------------------------------------------- node surface (gateway API)
    def signal(self):
        return self._call("signal")

    def can_admit(self, r_need: float, model: Optional[str] = None) -> bool:
        return self._call("can_admit", r_need, model)

    def t_act(self, model: str) -> float:
        return self._call("t_act", model)

    def degradation_cost(self, r_need: float) -> Optional[float]:
        return self._call("degradation_cost", r_need)

    def make_room(self, r_need: float) -> None:
        self._call("make_room", r_need)

    def submit(self, model: str, req: Request) -> None:
        self._call("submit", model, req)
        self._inflight += 1

    def preempt(self, model: str, req_id: int) -> Optional[Request]:
        req = self._call("preempt", model, req_id)
        if req is not None:
            self._inflight -= 1
            self._progress.pop(req_id, None)
        return req

    def kv_stats(self) -> Dict[str, float]:
        return self._call("kv_stats")

    def records(self) -> Dict[str, Any]:
        """The child's records (see ``_records``): activations, offloads,
        kernel launches and plain calls since :meth:`reset_records`, peak
        device memory, foreign modules loaded."""
        return self._call("records")

    def reset_records(self) -> None:
        """Zero the child's launch counts and its device's peak memory."""
        self._call("reset_records")

    # ------------------------------------------------- wall-clock free-run
    def set_continuous(self, on: bool = True) -> None:
        """Switch the child into (or out of) free-running mode: it steps
        its engines on its own whenever they hold work and buffers finished
        requests until the next :meth:`poll_finished`. Used by the gateway's
        wall clock; virtual runs never enable it."""
        self._call("continuous", bool(on))

    def has_work(self) -> bool:
        """Submitted-but-unfinished requests outstanding on this node (the
        gateway polls only such nodes — an idle worker costs no round
        trips)."""
        return self._inflight > 0

    def poll_send(self) -> None:
        """Arm a drain request at the free-running child without waiting for
        the reply (at most one poll is outstanding per worker). The child
        answers at its next engine-step boundary; the gateway folds the
        reply in with :meth:`drain_ready` on a later loop pass, so the
        wall-clock dispatch loop NEVER blocks on worker compute. Idle
        workers are skipped entirely."""
        if self._poll_pending or self._inflight == 0:
            return
        self.wait_ready()
        self._send("poll", ())
        self._expected.append(("poll",))
        self._poll_pending = True

    def drain_ready(self) -> Dict[str, List[Request]]:
        """Fold every reply already sitting in the pipe (poll reports,
        async submit acks) into handle state WITHOUT blocking, then return
        the finished requests accumulated since the last drain."""
        while self._expected and self._conn.poll(0):
            self._fold_async(self._expected.popleft())
        out, self._finished_buf = self._finished_buf, {}
        return out

    def submit_send(self, model: str, req: Request) -> None:
        """Asynchronous submit: fire the request and return immediately;
        the ack (or typed prompt-too-long rejection, surfaced through
        :meth:`take_submit_errors`) is folded in on a later drain — the
        pipe's FIFO order keeps reply pairing exact. A synchronous submit
        blocks until the child's engine-step boundary, which at wide batch
        sizes would stall the wall-clock dispatch loop for every stage."""
        self.wait_ready()
        self._send("submit", (model, req))
        self._expected.append(("submit", req.req_id))
        self._inflight += 1

    def ping_send(self) -> None:
        """Idle-period liveness probe (membership plane): fire a no-op
        round trip whose reply — folded in by :meth:`drain_ready` — is the
        heartbeat. Busy nodes are never pinged (their poll replies already
        carry liveness); if the previous ping is still unanswered when the
        next comes due, that is counted as a *heartbeat miss* instead of
        stacking another request behind a stalled worker."""
        if self._inflight > 0:
            return
        if self._ping_pending:
            self.heartbeat_misses += 1
            return
        self.wait_ready()
        self._send("ping", ())
        self._expected.append(("ping",))
        self._ping_pending = True

    def take_submit_errors(self) -> List[int]:
        """Request ids whose async submit was rejected (PromptTooLongError
        in the child) since the last call; the gateway finishes them
        truncated, mirroring the synchronous error path."""
        out, self._submit_errors = self._submit_errors, []
        return out

    def poll_finished(self) -> Dict[str, List[Request]]:
        """Blocking poll round trip: arm a poll (if none is outstanding)
        and wait for the child's report; returns everything finished since
        the last drain. Used by warmup; the serving loop uses the
        non-blocking poll_send/drain_ready pair instead."""
        self.poll_send()
        while self._poll_pending and self._expected:
            self._fold_async(self._expected.popleft())
        out, self._finished_buf = self._finished_buf, {}
        return out

    def last_signal(self):
        """The NodeSignal piggybacked on the most recent poll reply (None
        before the first poll). Under the wall clock the gateway schedules
        against this boundary-fresh report instead of blocking a synchronous
        signal/admission round trip per decision."""
        return self._cached_signal

    # ------------------------------------------------------------------ step
    def step_send(self) -> None:
        """Fire one engine iteration without waiting for the reply. Idle
        workers (nothing submitted and not yet finished) are skipped — an
        engine step with no waiting/active work is a no-op, so skipping the
        round trip changes nothing but the IPC bill."""
        if self._inflight == 0:
            self._step_pending = False
            return
        self.wait_ready()
        self._send("step", ())
        self._step_pending = True

    def step_recv(self) -> Dict[str, List[Request]]:
        """Collect the reply of the last ``step_send`` (finished requests by
        model), folding the worker's measured step wall-clock and per-request
        decode progress into the handle."""
        if self._step_buffer is not None:
            out, self._step_buffer = self._step_buffer, None
            return out
        if not self._step_pending:
            return {}
        return self._recv_step()

    def _send(self, method: str, args: tuple) -> None:
        """One request onto the transport; a dead peer surfaces as a typed
        :class:`WorkerDied` (node id attached) instead of a bare
        BrokenPipeError, so the gateway's membership plane can evacuate."""
        try:
            self._conn.send((method, args))
        except (BrokenPipeError, EOFError, OSError):
            raise WorkerDied(
                self.node_id,
                f"node {self.node_id} worker died before {method!r} "
                f"({self._exit_status()})")

    def _recv(self, method: str):
        """One reply off the transport; a dead peer surfaces as a typed
        :class:`WorkerDied` instead of a bare EOFError."""
        try:
            return self._conn.recv()
        except (EOFError, OSError):
            raise WorkerDied(
                self.node_id,
                f"node {self.node_id} worker died during {method!r} "
                f"({self._exit_status()})")

    def _recv_step(self) -> Dict[str, List[Request]]:
        # measure from recv START (not from the broadcast): time a reply
        # spends ready in the pipe while the gateway drains earlier nodes
        # is neither this node's compute nor IPC overhead
        t0 = time.perf_counter()
        kind, payload, step_wall = self._recv("step")
        elapsed = time.perf_counter() - t0
        self.ipc_calls += 1
        self._step_pending = False
        if kind != "ok":
            raise RuntimeError(
                f"node {self.node_id} worker error in step:\n{payload}")
        out, self._progress = payload
        # the step round trip is dominated by real engine compute; only the
        # residual (pipe + pickling + scheduling) is IPC overhead — charging
        # the whole wait would double-count worker_step_wall_s and inflate
        # the fleet-summed overhead by ~n_nodes under the overlapped tick.
        # (If the reply was not ready yet, elapsed still contains remaining
        # compute; subtracting the full step wall clamps that to 0 — the
        # counter may under-read pipe cost but never inflates it.)
        self.ipc_wall_s += max(0.0, elapsed - step_wall)
        self.worker_step_wall_s += step_wall
        for reqs in out.values():
            self._inflight -= len(reqs)
        return out

    def step(self) -> Dict[str, List[Request]]:
        self.step_send()
        return self.step_recv()

    def out_len(self, req_id: int) -> int:
        """Decode progress of an in-flight request as of the last collected
        step — the process-backend stand-in for reading ``req.out`` on the
        engine's own Request object."""
        return self._progress.get(req_id, 0)

    def worker_stats(self) -> Dict[str, float]:
        return {"ipc_calls": int(self.ipc_calls),
                "ipc_wall_s": float(self.ipc_wall_s),
                "worker_step_wall_s": float(self.worker_step_wall_s),
                "heartbeat_misses": int(self.heartbeat_misses)}


# ---------------------------------------------------------------------------
# socket backend: the same handle over the framed TCP transport
# ---------------------------------------------------------------------------

def _serve_conn(conn) -> None:
    """One gateway connection: validate the hello handshake (protocol
    version + WorkerSpec), then run the standard worker loop over the
    framed transport — ``_worker_main`` is transport-agnostic."""
    try:
        msg = conn.recv()
    except (EOFError, OSError):
        return
    if not (isinstance(msg, tuple) and len(msg) == 3 and msg[0] == "hello"):
        conn.send(("boot_error",
                   f"expected ('hello', version, WorkerSpec) handshake, "
                   f"got {type(msg).__name__}"))
        return
    _, version, spec = msg
    if version != PROTOCOL_VERSION:
        conn.send(("boot_error",
                   f"gateway speaks worker protocol {version}, this worker "
                   f"speaks {PROTOCOL_VERSION} — rebuild one side"))
        return
    _worker_main(conn, spec)


def _socket_child_main(bootstrap, host: str) -> None:
    """Locally spawned socket worker: bind an ephemeral port, report it over
    the one-shot bootstrap pipe, serve exactly one gateway connection."""
    srv = transport.listen(host, 0)
    bootstrap.send(srv.getsockname()[1])
    bootstrap.close()
    conn = transport.accept(srv)
    srv.close()
    try:
        _serve_conn(conn)
    finally:
        conn.close()


class SocketNodeHandle(NodeHandle):
    """:class:`NodeHandle` whose connection is a :class:`FrameTransport`
    over TCP instead of a multiprocessing pipe. All protocol machinery —
    the FIFO ``_expected`` pairing, the async poll/submit hot path, step
    broadcast, heartbeats — is inherited untouched: both connections expose
    the same ``send``/``recv``/``poll``/``close`` surface.

    Two ways to get one:

    - constructor: spawn the worker locally (child binds an ephemeral
      localhost port, reports it over a one-shot bootstrap pipe, parent
      connects) — this is what ``build_fleet(backend="socket")`` does, and
      it is protocol-identical to a remote worker;
    - :meth:`connect`: attach to a worker already listening elsewhere,
      started standalone with
      ``python -m repro_torch.serving.worker --listen``.
    """

    backend = "socket"

    def __init__(self, spec: WorkerSpec, ctx=None, host: str = "127.0.0.1",
                 boot_timeout_s: float = _BOOT_TIMEOUT_S):
        ctx = ctx or mp.get_context("spawn")
        self._init_state(spec)
        boot, child_boot = ctx.Pipe()
        self.proc = ctx.Process(target=_socket_child_main,
                                args=(child_boot, host),
                                name=f"maestro-socket-node-{spec.node_id}",
                                daemon=True)
        try:
            self.proc.start()
            child_boot.close()
            if not boot.poll(boot_timeout_s):
                raise WorkerDied(
                    self.node_id,
                    f"node {self.node_id} socket worker never reported "
                    f"its port ({self._exit_status()})")
            port = boot.recv()
            self.address = (host, int(port))
            self._conn = transport.connect(self.address)
            self._conn.send(("hello", PROTOCOL_VERSION, spec))
        except (EOFError, OSError) as e:
            self.close()
            raise WorkerDied(
                self.node_id,
                f"node {self.node_id} socket worker died while binding "
                f"({self._exit_status()}): {e}")
        except Exception:
            self.close()
            raise
        finally:
            boot.close()

    @classmethod
    def connect(cls, address, spec: WorkerSpec,
                timeout_s: float = 30.0) -> "SocketNodeHandle":
        """Attach to an already-running worker (``python -m
        repro_torch.serving.worker --listen HOST:PORT`` on the other host).
        ``address`` is ``"host:port"`` or a ``(host, port)`` tuple; the
        returned handle owns no local process (``proc is None``)."""
        self = cls.__new__(cls)
        self._init_state(spec)
        self.proc = None
        self.address = (transport.parse_address(address)
                        if isinstance(address, str) else
                        (address[0], int(address[1])))
        try:
            self._conn = transport.connect(self.address, timeout_s=timeout_s)
            self._conn.send(("hello", PROTOCOL_VERSION, spec))
        except OSError as e:
            self.close()
            raise WorkerDied(
                self.node_id,
                f"node {self.node_id}: cannot reach worker at "
                f"{self.address[0]}:{self.address[1]}: {e}")
        return self

    def worker_stats(self) -> Dict[str, float]:
        s = super().worker_stats()
        conn = getattr(self, "_conn", None)
        if conn is not None:
            # transport-overhead columns for BENCH_gateway_socket.json
            s["bytes_sent"] = int(conn.bytes_sent)
            s["bytes_recv"] = int(conn.bytes_recv)
        return s


# ---------------------------------------------------------------------------
# fleet lifecycle
# ---------------------------------------------------------------------------

_HANDLE_CLASSES = {"process": NodeHandle, "socket": SocketNodeHandle}


def spawn_fleet(specs: Sequence[WorkerSpec],
                backend: str = "process") -> List[NodeHandle]:
    """Spawn one worker per spec, booting in parallel: all processes start
    before any ready handshake is awaited, so fleet boot costs the slowest
    node, not the sum. If any constructor or handshake fails, every
    already-started worker is torn down before the error propagates — a
    failed spawn leaks no processes."""
    try:
        cls = _HANDLE_CLASSES[backend]
    except KeyError:
        raise ValueError(f"unknown worker backend {backend!r} "
                         f"(expected one of {sorted(_HANDLE_CLASSES)})")
    ctx = mp.get_context("spawn")
    handles: List[NodeHandle] = []
    try:
        for s in specs:
            handles.append(cls(s, ctx=ctx))
        for h in handles:
            h.wait_ready()
    except Exception:
        close_fleet(handles)
        raise
    return handles


def connect_fleet(addresses: Sequence[Any],
                  specs: Sequence[WorkerSpec]) -> List[NodeHandle]:
    """Attach to standalone socket workers already listening at
    ``addresses`` ("host:port" strings or tuples, one per spec, same
    order). Same teardown-on-failure contract as :func:`spawn_fleet`."""
    if len(addresses) != len(specs):
        raise ValueError(f"{len(addresses)} addresses for "
                         f"{len(specs)} specs")
    handles: List[NodeHandle] = []
    try:
        for addr, spec in zip(addresses, specs):
            handles.append(SocketNodeHandle.connect(addr, spec))
        for h in handles:
            h.wait_ready()
    except Exception:
        close_fleet(handles)
        raise
    return handles


def close_fleet(fleet: Sequence[Any]) -> None:
    """Shut down every worker handle in a (possibly mixed) fleet; in-process
    ``NodeRuntime`` members are left untouched. Safe to call even when the
    gateway was never constructed (the constructor-failure path), safe on
    half-constructed handles, and safe to call twice — handle close is
    idempotent and a close failure never strands the rest of the fleet."""
    for node in fleet:
        if hasattr(node, "close"):
            try:
                node.close()
            except Exception:       # best-effort teardown: keep going
                traceback.print_exc()


# ---------------------------------------------------------------------------
# standalone worker entry point (remote hosts)
# ---------------------------------------------------------------------------

def main(argv: Optional[Sequence[str]] = None) -> None:
    """``python -m repro_torch.serving.worker --listen HOST:PORT`` — run a
    worker that serves gateway connections over the socket transport. The
    node's configuration (``WorkerSpec``) arrives in the gateway's hello, so
    one listening worker can serve successive runs with different specs."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serving.worker",
        description="Standalone Maestro worker node (socket transport). "
                    "TRUSTED NETWORKS ONLY: the wire protocol is pickle.")
    ap.add_argument("--listen", required=True, metavar="HOST:PORT",
                    help="bind address (port 0 picks an ephemeral port)")
    ap.add_argument("--once", action="store_true",
                    help="exit after serving one gateway connection "
                         "instead of accepting the next")
    args = ap.parse_args(argv)
    host, port = transport.parse_address(args.listen)
    srv = transport.listen(host, port)
    bound = srv.getsockname()
    print(f"[worker] listening on {bound[0]}:{bound[1]}", flush=True)
    try:
        while True:
            conn = transport.accept(srv)
            try:
                _serve_conn(conn)
            finally:
                conn.close()
            if args.once:
                break
    except KeyboardInterrupt:
        pass
    finally:
        srv.close()


if __name__ == "__main__":
    main()
