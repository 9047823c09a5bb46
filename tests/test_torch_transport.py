"""The port's socket transport and socket node backend, on the CPU.

Framing unit tests (the reference's ``tests/test_transport.py`` cases), the
port's frames against the reference's byte for byte, the socket fleet
against the in-process fleet under the virtual clock, and the standalone
``python -m repro_torch.serving.worker --listen`` entry point reached
through ``build_fleet(worker_addresses=...)``.
"""
import dataclasses
import os
import re
import socket
import struct
import subprocess
import sys

import pytest
import torch

from _stubs import StubPred
from repro.serving import transport as ref_transport
from repro_torch.serving import transport
from repro_torch.serving.cluster import ClusterSpec, NodeSpec, worker_specs
from repro_torch.serving.engine import Request
from repro_torch.serving.transport import (FRAME_VERSION, MAGIC,
                                           FrameTransport,
                                           ProtocolVersionError,
                                           TransportError, parse_address)
from repro_torch.serving.worker import SocketNodeHandle
from test_torch_worker import (RTT, TWO_NODES, ZOO_NAMES, assert_parity,
                               run_fleet, trace_jobs)


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """One intra-op thread here and in every spawned worker (see
    ``test_torch_worker.py``)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair():
    a, b = socket.socketpair()
    return FrameTransport(a), FrameTransport(b)


# ---------------------------------------------------------------- framing

def test_frame_roundtrip_and_counters():
    a, b = _pair()
    try:
        payloads = [("step", ()), {"x": [1, 2, 3]}, None,
                    Request(req_id=9, tokens=[1, 2], max_new=4)]
        for obj in payloads:
            a.send(obj)
        for obj in payloads:
            got = b.recv()
            if isinstance(obj, Request):
                assert got.req_id == obj.req_id and got.tokens == obj.tokens
            else:
                assert got == obj
        assert a.frames_sent == b.frames_recv == len(payloads)
        assert a.bytes_sent == b.bytes_recv > 0
        assert a.bytes_recv == b.bytes_sent == 0
    finally:
        a.close()
        b.close()


def test_poll_semantics():
    a, b = _pair()
    try:
        assert not b.poll(0.0)
        a.send("hello")
        assert b.poll(1.0)
        assert b.recv() == "hello"
        assert not b.poll(0.0)
    finally:
        a.close()
        b.close()


def test_eof_on_peer_close():
    a, b = _pair()
    a.close()
    try:
        assert b.poll(1.0)               # EOF counts as readable
        with pytest.raises(EOFError):
            b.recv()
    finally:
        b.close()


def _raw_header(magic, version, length):
    return struct.Struct("!4sBxxxI").pack(magic, version, length)


@pytest.mark.parametrize("header, error, match", [
    (b"GARBAGE_" + b"\x00" * 8, TransportError, "magic"),
    (_raw_header(MAGIC, FRAME_VERSION + 1, 0), ProtocolVersionError,
     "version"),
    (_raw_header(MAGIC, FRAME_VERSION, transport.MAX_FRAME_BYTES + 1),
     TransportError, "length"),
], ids=["bad_magic", "version_mismatch", "oversized"])
def test_malformed_frames_are_rejected_typed(header, error, match):
    a, b = socket.socketpair()
    t = FrameTransport(b)
    try:
        a.sendall(header)
        with pytest.raises(error, match=match):
            t.recv()
    finally:
        a.close()
        t.close()


def test_close_idempotent():
    a, b = _pair()
    b.close()
    a.close()
    a.close()                            # second close is a no-op


def test_parse_address():
    assert parse_address("127.0.0.1:9000") == ("127.0.0.1", 9000)
    assert parse_address("host.example:0") == ("host.example", 0)
    for bad in ("nohost", ":123", "h:", "h:port"):
        with pytest.raises(ValueError):
            parse_address(bad)


def _wire_bytes(module, objs):
    """The bytes ``module.FrameTransport`` puts on the wire for ``objs``."""
    a, b = socket.socketpair()
    t = module.FrameTransport(a)
    try:
        for obj in objs:
            t.send(obj)
        want, got = t.bytes_sent, b""
        while len(got) < want:
            got += b.recv(want - len(got))
        return got
    finally:
        t.close()
        b.close()


def test_frames_equal_the_reference_byte_for_byte():
    """For plain data the port's frames are the reference's: the same
    header constants and the same pickled payloads."""
    assert (MAGIC, FRAME_VERSION, transport.MAX_FRAME_BYTES) == (
        ref_transport.MAGIC, ref_transport.FRAME_VERSION,
        ref_transport.MAX_FRAME_BYTES)
    objs = [("step", ()), ("submit", (3, "qwen3-8b")), (1, 2, -7),
            ("hello", 1, ("a", "bc", 40000)), ("continuous", (True,))]
    assert _wire_bytes(transport, objs) == _wire_bytes(ref_transport, objs)


def test_a_request_carries_the_reference_fields_byte_for_byte():
    """The port's ``Request`` has the reference's fields in its order, with
    its defaults, ``extras`` (None from the gateway) included: a request's
    field values travel in frames equal to the reference's."""
    from repro.serving.engine import Request as RefRequest
    names = [f.name for f in dataclasses.fields(Request)]
    assert names == [f.name for f in dataclasses.fields(RefRequest)]
    kw = dict(req_id=4, tokens=[5, 6, 7], max_new=9, pred_len=11.5)
    req, ref = Request(**kw), RefRequest(**kw)
    assert req.extras is None and ref.extras is None
    objs = [("submit", ("whisper-medium", vars(req)))]
    assert _wire_bytes(transport, objs) == _wire_bytes(
        ref_transport, [("submit", ("whisper-medium", vars(ref)))])


# ------------------------------------------------- socket backend parity

@pytest.mark.parametrize("policy", ["fcfs", "maestro"])
def test_socket_backend_equals_the_inproc_fleet(policy):
    """Localhost socket fleet under the virtual clock: the in-process
    fleet's stages and metrics, with real bytes on the wire."""
    pred = StubPred(length=lambda obs: 8.0 + obs.prompt_len % 13)
    m_in, ev_in = run_fleet("inproc", trace_jobs, TWO_NODES, policy, pred)
    m_sock, ev_sock = run_fleet("socket", trace_jobs, TWO_NODES, policy,
                                pred)
    assert m_sock.node_backend == "socket"
    assert_parity(m_in, ev_in, m_sock, ev_sock)
    assert m_sock.rpc_bytes_sent > 0 and m_sock.rpc_bytes_recv > 0
    assert set(m_sock.worker_stats) == {0, 1}
    for stats in m_sock.worker_stats.values():
        assert stats["bytes_sent"] > 0 and stats["bytes_recv"] > 0
    assert m_in.rpc_bytes_sent == 0


# --------------------------------------------- standalone worker process

def _start_cli_worker():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (env.get("PYTHONPATH"),
                    os.path.join(os.path.dirname(__file__), "..", "src"))
        if p)
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.serving.worker",
         "--listen", "127.0.0.1:0", "--once"],
        stdout=subprocess.PIPE, text=True, env=env)
    line = proc.stdout.readline()
    m = re.search(r"listening on ([\d.]+):(\d+)", line)
    assert m, f"no listen banner in {line!r}"
    return proc, f"{m.group(1)}:{m.group(2)}"


def test_standalone_worker_cli_through_worker_addresses():
    """`python -m repro_torch.serving.worker --listen --once` serves one
    gateway connection: a one-node socket fleet built through
    ``build_fleet(worker_addresses=...)`` gives the in-process run."""
    specs = [NodeSpec(0, max_slots=2)]
    m_in, ev_in = run_fleet("inproc", trace_jobs, specs)
    proc, address = _start_cli_worker()
    try:
        m_cli, ev_cli = run_fleet("socket", trace_jobs, specs,
                                  worker_addresses=[address])
    finally:
        proc.wait(timeout=60)
    assert proc.returncode == 0
    assert m_cli.node_backend == "socket" and m_cli.rpc_bytes_sent > 0
    assert_parity(m_in, ev_in, m_cli, ev_cli)


def test_standalone_worker_handle():
    """``SocketNodeHandle.connect``: a handle that owns no local child."""
    proc, address = _start_cli_worker()
    h = None
    try:
        spec = worker_specs(ClusterSpec(nodes=(NodeSpec(0),), rtt_s=RTT,
                                        model_names=ZOO_NAMES),
                            device="cpu")[0]
        h = SocketNodeHandle.connect(address, spec)
        h.wait_ready()
        assert h.proc is None                       # no local child
        assert set(h.profiles) == set(ZOO_NAMES)
        assert h.signal().node_id == 0
        h.submit(ZOO_NAMES[0], Request(req_id=1, tokens=[1, 2, 3],
                                       max_new=2))
        done = {}
        for _ in range(20):
            for _, reqs in h.step().items():
                done.update((r.req_id, r) for r in reqs)
            if done:
                break
        assert len(done[1].out) == 2
        assert h.records()["foreign_modules"] == []
        assert h.worker_stats()["bytes_sent"] > 0
    finally:
        if h is not None:
            h.close()
            h.close()                               # idempotent
        proc.wait(timeout=60)
    assert proc.returncode == 0
