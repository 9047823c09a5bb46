"""Socket transport: length-prefixed, versioned TCP framing of the worker
request/reply protocol.

The process backend speaks its protocol over ``multiprocessing`` pipes,
which confines the fleet to one host. This module provides the same
connection surface — ``send`` / ``recv`` / ``poll`` / ``close``, blocking
FIFO request/reply semantics — over a TCP socket, so a ``NodeRuntime``
worker can live on any reachable machine while the gateway-side protocol
machinery (:class:`repro_torch.serving.worker.NodeHandle`) runs unchanged.

Framing: every frame is a fixed 12-byte header followed by the payload::

    !4s  B    xxx  I        MAGIC  b"MAES"
    magic ver pad  length   FRAME_VERSION 1 (bumped on any wire change)

Both magic and version are validated on every frame, so a cross-version
gateway/worker pair fails with a typed :class:`ProtocolVersionError`
instead of desynchronizing mid-stream. On top of the framing sits a small
codec seam (:class:`Codec`): payloads default to pickle
(:class:`PickleCodec`) because the protocol ships plain dataclasses
(``Request``, ``NodeSignal``, ``WorkerSpec``) exactly as the pipes did.

SECURITY: pickle executes arbitrary code at load time. This transport is a
*trusted-network* fabric (the same trust model as the multiprocessing
pipes it generalizes) — run workers only on hosts and networks you
control, never exposed to untrusted peers. A hardened codec can be slotted
in behind the :class:`Codec` seam without touching the protocol.

The transport counts bytes and frames in both directions
(``bytes_sent`` / ``bytes_recv``), which the gateway surfaces as the
per-node transport-overhead columns in ``BENCH_gateway_socket.json``.
"""
from __future__ import annotations

import pickle
import select
import socket
import struct
import time
from typing import Any, Optional, Protocol, Tuple

MAGIC = b"MAES"
#: bumped on ANY wire-format change; validated on every frame
FRAME_VERSION = 1
_HEADER = struct.Struct("!4sBxxxI")           # magic, version, pad, length
#: sanity bound on one frame's payload (a corrupt length prefix must not
#: make the receiver try to allocate terabytes)
MAX_FRAME_BYTES = 1 << 30


class TransportError(RuntimeError):
    """Wire-level framing violation (bad magic, oversized frame)."""


class ProtocolVersionError(TransportError):
    """Peer speaks a different FRAME_VERSION; fail typed, not garbled."""


class Codec(Protocol):
    """Payload (de)serialization seam under the framing layer."""

    name: str

    def dumps(self, obj: Any) -> bytes: ...

    def loads(self, data: bytes) -> Any: ...


class PickleCodec:
    """Default codec: pickle, exactly what the multiprocessing pipes used
    (trusted-network only — see module docstring)."""

    name = "pickle"

    def dumps(self, obj: Any) -> bytes:
        return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)

    def loads(self, data: bytes) -> Any:
        return pickle.loads(data)


class FrameTransport:
    """One framed, codec'd TCP connection with ``multiprocessing.Connection``
    semantics: blocking ``recv`` of whole objects, ``poll(timeout)`` for
    readability, ``EOFError`` when the peer is gone. Drop-in for the pipe
    inside :class:`repro_torch.serving.worker.NodeHandle` and
    ``_worker_main``."""

    def __init__(self, sock: socket.socket, codec: Optional[Codec] = None):
        sock.settimeout(None)                  # blocking; poll() does waits
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:                         # pragma: no cover
            pass                                # non-TCP test doubles
        self._sock = sock
        self.codec: Codec = codec or PickleCodec()
        self.bytes_sent = 0
        self.bytes_recv = 0
        self.frames_sent = 0
        self.frames_recv = 0
        self._closed = False

    # ------------------------------------------------------------- protocol
    def send(self, obj: Any) -> None:
        payload = self.codec.dumps(obj)
        frame = _HEADER.pack(MAGIC, FRAME_VERSION, len(payload)) + payload
        self._sock.sendall(frame)
        self.bytes_sent += len(frame)
        self.frames_sent += 1

    def recv(self) -> Any:
        hdr = self._recv_exact(_HEADER.size)
        magic, version, length = _HEADER.unpack(hdr)
        if magic != MAGIC:
            raise TransportError(
                f"bad frame magic {magic!r} (expected {MAGIC!r}) — peer is "
                f"not a maestro worker transport")
        if version != FRAME_VERSION:
            raise ProtocolVersionError(
                f"frame version {version} != local {FRAME_VERSION} — "
                f"gateway and worker builds are incompatible")
        if length > MAX_FRAME_BYTES:
            raise TransportError(f"frame length {length} exceeds "
                                 f"{MAX_FRAME_BYTES} — corrupt stream")
        payload = self._recv_exact(length)
        self.bytes_recv += _HEADER.size + length
        self.frames_recv += 1
        return self.codec.loads(payload)

    def poll(self, timeout: Optional[float] = 0.0) -> bool:
        """True when a frame (or EOF) is readable. ``timeout=None`` blocks;
        EOF counts as readable so a dead peer is noticed immediately, like
        a pipe whose writer exited."""
        if self._closed:
            raise OSError("transport is closed")
        r, _, _ = select.select([self._sock], [], [], timeout)
        return bool(r)

    def _recv_exact(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise EOFError("socket closed by peer")
            buf += chunk
        return bytes(buf)

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass                                # already reset/closed
        self._sock.close()

    def fileno(self) -> int:
        return self._sock.fileno()


# ---------------------------------------------------------------------------
# connection helpers
# ---------------------------------------------------------------------------

def parse_address(text: str) -> Tuple[str, int]:
    """``"host:port"`` -> ``(host, port)`` (the ``--listen`` CLI format)."""
    host, _, port = text.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"expected HOST:PORT, got {text!r}")
    return host, int(port)


def listen(host: str, port: int, backlog: int = 8) -> socket.socket:
    """Bound + listening server socket (``port=0`` picks an ephemeral
    port; read it back from ``sock.getsockname()[1]``)."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(backlog)
    return srv


def accept(srv: socket.socket,
           codec: Optional[Codec] = None) -> FrameTransport:
    sock, _peer = srv.accept()
    return FrameTransport(sock, codec=codec)


def connect(address: Tuple[str, int], timeout_s: float = 30.0,
            retry_s: float = 0.05,
            codec: Optional[Codec] = None) -> FrameTransport:
    """Connect to a listening worker, retrying briefly (a worker started a
    moment ago may not have reached ``listen`` yet)."""
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            sock = socket.create_connection(address, timeout=timeout_s)
            return FrameTransport(sock, codec=codec)
        except OSError:
            if time.monotonic() >= deadline:
                raise
            time.sleep(retry_s)
