"""The application SPI.

Mirrors the reference's ``Replicable`` interface
(``gigapaxos/interfaces/Replicable.java:3-15``): an app executes totally
ordered requests and supports state checkpoint/restore per service name.
Determinism contract is identical: given the same request sequence, every
replica's app must reach the same state (``execute`` may not depend on
anything but (name, request)).

Host apps subclass :class:`Replicable`: arbitrary Python, executed on the
host from the device's decision stream.  The device-resident KV app is
``models/device_kv.py``.
"""

from __future__ import annotations

import abc


class Replicable(abc.ABC):
    @abc.abstractmethod
    def execute(self, name: str, request: bytes, request_id: int) -> bytes:
        """Apply one committed request; returns the client response payload.

        Must retry internal failures rather than skip — the reference
        deliberately retries forever (PaxosInstanceStateMachine.java:1829-1839)
        because consensus has already happened; skipping would fork replicas.
        """

    def execute_batch(self, names, requests, request_ids):
        """Apply one tick's worth of committed requests (already in commit
        order per name); returns one response per request.

        Default delegates to :meth:`execute` per request.  High-throughput
        apps override with a vectorized implementation — on the dense data
        plane the per-request Python dispatch is the bottleneck, not the
        app logic (the BatchedLogger/RequestBatcher lesson of
        ``gigapaxos/RequestBatcher.java:25-60`` applied to execution)."""
        return [
            self.execute(n, q, r)
            for n, q, r in zip(names, requests, request_ids)
        ]

    @abc.abstractmethod
    def checkpoint(self, name: str) -> bytes:
        """Serialize the app state for `name` (empty state -> b'')."""

    @abc.abstractmethod
    def restore(self, name: str, state: bytes) -> None:
        """Reset app state for `name` to a checkpoint (b'' -> fresh)."""


class NoopApp(Replicable):
    """The capacity-test app (``testing/NoopPaxosApp.java:16``): no state,
    echoes."""

    def execute(self, name: str, request: bytes, request_id: int) -> bytes:
        return b"ok:" + request

    def execute_batch(self, names, requests, request_ids):
        # must match execute() byte-for-byte: a request's response may not
        # depend on which internal path (scalar vs vectorized) ran it
        return [b"ok:" + q for q in requests]

    def checkpoint(self, name: str) -> bytes:
        return b""

    def restore(self, name: str, state: bytes) -> None:
        pass


class KVApp(Replicable):
    """A tiny deterministic KV store per service name.

    Request format (utf-8): ``PUT <key> <value>`` | ``GET <key>`` |
    ``DEL <key>``; the workload analog of ``TESTPaxosApp.java:60``.
    """

    def __init__(self):
        self.db: dict[str, dict[str, str]] = {}

    def _table(self, name: str) -> dict[str, str]:
        return self.db.setdefault(name, {})

    def execute(self, name: str, request: bytes, request_id: int) -> bytes:
        parts = request.decode().split(" ", 2)
        t = self._table(name)
        op = parts[0]
        if op == "PUT" and len(parts) == 3:
            t[parts[1]] = parts[2]
            return b"OK"
        if op == "GET" and len(parts) >= 2:
            v = t.get(parts[1])
            return b"NF" if v is None else v.encode()
        if op == "DEL" and len(parts) >= 2:
            return b"OK" if t.pop(parts[1], None) is not None else b"NF"
        return b"ERR"

    def checkpoint(self, name: str) -> bytes:
        import json

        t = self.db.get(name)
        return b"" if not t else json.dumps(t, sort_keys=True).encode()

    def restore(self, name: str, state: bytes) -> None:
        import json

        if state:
            self.db[name] = json.loads(state.decode())
        else:
            self.db.pop(name, None)


class AppStop:
    """Marker mixin: apps may inspect request==STOP_PAYLOAD for epoch-final
    cleanup; the framework treats stops specially regardless."""


STOP_PAYLOAD = b"\x00__stop__"
