"""The worker plane's names the gateway imports: :class:`WorkerDied` and
:func:`close_fleet`, the port's copies of those in
``repro/serving/worker.py``.

The worker processes themselves (``NodeHandle``, ``SocketNodeHandle``,
``spawn_fleet``, the standalone ``--listen`` entry point) are not ported
yet: ``build_fleet(backend="process"|"socket")`` raises
``NotImplementedError``. A fleet of in-process ``NodeRuntime`` objects
holds no handle, so :func:`close_fleet` leaves it untouched.
"""
from __future__ import annotations

import traceback
from typing import Any, Sequence


class WorkerDied(RuntimeError):
    """A worker's transport failed mid-protocol: the process was killed
    (OOM/segfault/SIGKILL) or the socket peer vanished. Carries the node id
    so the gateway's membership plane can evacuate exactly that node."""

    def __init__(self, node_id: int, msg: str):
        super().__init__(msg)
        self.node_id = node_id


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
