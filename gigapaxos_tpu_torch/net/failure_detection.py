"""Keep-alive failure detection over the messenger.

Analog of ``gigapaxos/FailureDetection.java:45-60``: each node periodically
pings the nodes it monitors; a node is up iff heard from within a timeout.
Same design decisions as the reference:

* per-*node* (host) detection, never per-group — one pinger covers every
  group two nodes share (class doc FailureDetection.java:50-55);
* ping rate capped (``:63-66``: max 1/100ms) with the timeout a multiple of
  the ping interval;
* ``heardFrom`` is fed by *any* inbound packet, not just pongs — real
  traffic is implicit keep-alive (``heardFrom :248``).

Role here (SURVEY §2.1 FailureDetection row): the aggregate liveness
view is exported as a dense bool ``[R]`` mask (``alive_mask``) and uploaded
into the tick inbox, where it drives the branch-free coordinator-election
phase (ops/tick.py phase 0) — the device-side analog of
``checkRunForCoordinator`` consulting ``isNodeUp``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np

from .messenger import Messenger

PING = "fd_ping"
PONG = "fd_pong"


class FailureDetection:
    def __init__(
        self,
        messenger: Messenger,
        monitored: Iterable[str] = (),
        ping_interval_s: float = 0.1,
        timeout_s: float = 3.0,
        on_change: Optional[Callable[[str, bool], None]] = None,
        adaptive: bool = False,
        adaptive_beta: float = 1.5,
        adaptive_gain: float = 0.125,
    ):
        self.m = messenger
        self.me = messenger.node_id
        self.ping_interval_s = max(ping_interval_s, 0.01)
        self.timeout_s = max(timeout_s, 2 * self.ping_interval_s)
        self.on_change = on_change
        # Adaptive timeout (Jacobson RTO-style): per-node EWMA of
        # inter-arrival gaps and their mean deviation; effective timeout =
        # max(timeout_s, beta * (mean + 4 * dev)).  Floored at the
        # configured value — adaptation only ever LENGTHENS the fuse on
        # jittery links (so WAN delay spikes don't flap the alive mask into
        # dueling-coordinator churn), never shortens it below config.
        self.adaptive = adaptive
        self.adaptive_beta = adaptive_beta
        self.adaptive_gain = adaptive_gain
        self._gap_mean: Dict[str, float] = {}
        self._gap_dev: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._monitored: List[str] = []
        self._last_heard: Dict[str, float] = {}
        self._was_up: Dict[str, bool] = {}
        self._stop = threading.Event()
        messenger.register(PING, self._on_ping)
        messenger.register(PONG, self._on_pong)
        # any inbound frame is implicit keep-alive (heardFrom,
        # FailureDetection.java:248) — not just pongs
        self._tap = lambda sender, _kind: self.heard_from(sender)
        messenger.demux.add_tap(self._tap)
        for n in monitored:
            self.monitor(n)
        self._thread = threading.Thread(
            target=self._run, name=f"fd-{self.me}", daemon=True
        )
        self._thread.start()

    # ----------------------------------------------------------------- public
    def monitor(self, node: str) -> None:
        """Start monitoring (idempotent).  A just-added node gets a grace
        window of one timeout before being reported down — the reference
        likewise initializes lastHeardFrom on first monitor."""
        if node == self.me:
            return
        with self._lock:
            if node not in self._monitored:
                self._monitored.append(node)
                self._last_heard.setdefault(node, time.monotonic())
                self._was_up.setdefault(node, True)

    def unmonitor(self, node: str) -> None:
        with self._lock:
            if node in self._monitored:
                self._monitored.remove(node)
            # forget history so a later re-monitor gets a fresh grace window
            self._last_heard.pop(node, None)
            self._was_up.pop(node, None)
            self._gap_mean.pop(node, None)
            self._gap_dev.pop(node, None)

    def heard_from(self, node: str) -> None:
        """Feed from any inbound packet (wire into the demux default path).

        Only monitored peers are tracked — the tap sees every inbound frame,
        including ones from ephemeral client ids, which must not accrete
        state here."""
        now = time.monotonic()
        with self._lock:
            last = self._last_heard.get(node)
            if last is None:
                return
            self._last_heard[node] = now
            if self.adaptive:
                gap = now - last
                g = self.adaptive_gain
                mean = self._gap_mean.get(node)
                if mean is None:
                    self._gap_mean[node] = gap
                    self._gap_dev[node] = gap / 2.0
                else:
                    err = gap - mean
                    self._gap_mean[node] = mean + g * err
                    self._gap_dev[node] = (
                        self._gap_dev[node]
                        + g * (abs(err) - self._gap_dev[node])
                    )

    def current_timeout(self, node: str) -> float:
        """Effective timeout for ``node``: the configured floor, lengthened
        by the adaptive inter-arrival estimate when enabled."""
        if not self.adaptive:
            return self.timeout_s
        with self._lock:
            mean = self._gap_mean.get(node)
            dev = self._gap_dev.get(node, 0.0)
        if mean is None:
            return self.timeout_s
        return max(self.timeout_s,
                   self.adaptive_beta * (mean + 4.0 * dev))

    def is_node_up(self, node: str) -> bool:
        """``isNodeUp`` (FailureDetection.java:252-258); self is always up."""
        if node == self.me:
            return True
        with self._lock:
            last = self._last_heard.get(node)
        return (last is not None
                and (time.monotonic() - last) < self.current_timeout(node))

    def alive_mask(self, nodes: List[str]) -> np.ndarray:
        """Dense liveness view for the tick inbox: nodes[i] -> alive[i]."""
        return np.array([self.is_node_up(n) for n in nodes], dtype=bool)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2)
        # detach from the shared messenger so a closed detector stops being
        # invoked (and mutating state) on later frames
        self.m.demux.remove_tap(self._tap)

    # ---------------------------------------------------------------- private
    def _on_ping(self, sender: str, packet: dict) -> None:
        self.heard_from(sender)
        self.m.send(sender, {"type": PONG})

    def _on_pong(self, sender: str, packet: dict) -> None:
        self.heard_from(sender)

    def _run(self) -> None:
        while not self._stop.wait(self.ping_interval_s):
            with self._lock:
                targets = list(self._monitored)
            for n in targets:
                self.m.send(n, {"type": PING})
            # edge-triggered up/down notifications
            if self.on_change is not None:
                for n in targets:
                    up = self.is_node_up(n)
                    if self._was_up.get(n) != up:
                        self._was_up[n] = up
                        try:
                            self.on_change(n, up)
                        except Exception:
                            pass
