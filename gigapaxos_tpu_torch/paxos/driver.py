"""TickDriver: the thread that pumps the device data plane.

The reference's data plane is driven by packet arrival (NIO threads call
``PaxosManager.handleIncomingPacket``); the dense design instead advances
*all* groups in one fused device step, so something must call
``manager.tick()`` repeatedly.  This driver is that something: it ticks
eagerly while work is pending (queued proposals, undelivered windows) and
backs off to a low idle rate otherwise — the RequestBatcher's adaptive-sleep
idea (``gigapaxos/RequestBatcher.java:25-60``) applied to the whole plane.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

from ..wal.logger import WalError
from .manager import PaxosManager

log = logging.getLogger(__name__)

#: process-wide hook for unrecoverable storage failures surfacing in a tick
#: loop (fsyncgate semantics: the kernel may have dropped dirty pages, so
#: retrying the write would ack data that never reached disk).  A worker
#: process installs a handler that exits nonzero so its supervisor restarts
#: it onto intact storage; in-process embeddings (tests, notebooks) leave
#: it None and observe ``driver.fatal`` instead — the driver thread stops
#: ticking either way, which is exactly "the node stops acking".
FATAL_HANDLER: Optional[Callable[[BaseException], None]] = None


class TickDriver:
    def __init__(
        self,
        manager: PaxosManager,
        idle_sleep_s: float = 0.002,
        drain_ticks: int = 4,
    ):
        """``drain_ticks``: extra ticks after the queues empty so in-flight
        device state (accepted-but-undecided slots, ring-buffer deliveries)
        reaches quiescence before the driver goes idle."""
        self.manager = manager
        self.idle_sleep_s = idle_sleep_s
        self.drain_ticks = drain_ticks
        #: the WalError that fail-stopped this driver, if any
        self.fatal: Optional[BaseException] = None
        self._stop = threading.Event()
        self._kick = threading.Event()
        self._first_tick = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="tick-driver", daemon=True
        )

    def start(self) -> "TickDriver":
        self._thread.start()
        return self

    def kick(self) -> None:
        """Wake the driver immediately (call after enqueuing proposals)."""
        self._kick.set()

    def wait_ready(self, timeout_s: float = 120.0) -> bool:
        """Block until the first tick completed — i.e. the kernels are
        built and the plane answers at interactive latency."""
        return self._first_tick.wait(timeout=timeout_s)

    def stop(self) -> None:
        self._stop.set()
        self._kick.set()
        self._thread.join(timeout=10)
        # a pipelined manager may hold one final unprocessed outbox whose
        # callbacks clients are still waiting on
        drain = getattr(self.manager, "drain_pipeline", None)
        if drain is not None:
            drain()

    def _run(self) -> None:
        drain = self.drain_ticks
        lock = getattr(self.manager, "lock", None)
        counted = hasattr(lock, "waiters")
        min_ivl = getattr(
            getattr(self.manager.cfg, "paxos", None),
            "min_tick_interval_s", 0.0,
        ) or 0.0
        last = 0.0
        while not self._stop.is_set():
            if min_ivl > 0:
                gap = min_ivl - (time.monotonic() - last)
                if gap > 0:
                    time.sleep(gap)  # coalesce: let requests accumulate
                last = time.monotonic()
            try:
                self.manager.tick()
            except WalError as e:
                # fail-stop: storage lost (or refused) a write the plane
                # was about to ack.  Stop ticking — no further decision is
                # acked from this node — and surface the failure instead of
                # dying as a silent daemon thread.
                self.fatal = e
                log.critical("tick driver fail-stop (WAL): %s", e)
                self._first_tick.set()  # unblock wait_ready() callers
                handler = FATAL_HANDLER
                if handler is not None:
                    handler(e)
                return
            self._first_tick.set()
            # CPython locks are unfair: without a yield window the driver
            # re-acquires manager.lock before any waiting control-plane
            # thread (propose, create, stop) gets scheduled, starving them
            # indefinitely.  Blocked acquirers register in lock.waiters
            # (utils/locking.py), so the window is paid per tick for as long
            # as someone is STILL waiting — not just once per flag edge.
            if not counted:
                time.sleep(0.0005)
            elif lock.waiters > 0:
                time.sleep(0.0005)
            else:
                # clients stage proposals without touching the lock now, so
                # lock contention no longer signals their presence: yield
                # the GIL so messenger/client threads run on few-core hosts
                time.sleep(0)
            busy = self.manager.pending_count() > 0
            if not busy:
                # decided_now needs a device sync; only check when draining
                drain -= 1
                if drain <= 0:
                    self._kick.wait(timeout=self.idle_sleep_s)
                    self._kick.clear()
                    drain = 1  # idle wake: one probe tick, drain more if busy
            else:
                drain = self.drain_ticks
