"""Protocol-task runtime: keyed async workflow tasks with periodic restarts.

Analog of the reference's ``protocoltask`` package (SURVEY §2.6):

* ``ProtocolExecutor`` (``protocoltask/ProtocolExecutor.java:50``) — a keyed
  task registry; every registered task is restarted on a period until it
  declares itself done or is canceled, which is what gives the epoch
  workflows (stop/start/drop epoch) their liveness under message loss;
* ``ThresholdProtocolTask`` — the wait-for-threshold-of-replies abstraction
  used by all reconfiguration epoch tasks
  (``reconfigurationprotocoltasks/WaitAckStopEpoch.java:38`` etc.).

Design: one scheduler thread + heapq timer wheel instead of the reference's
ScheduledThreadPoolExecutor; tasks emit ``(dest_node_id, packet)`` pairs that
the owner forwards through its messenger.  Event routing is by task key —
the owner demultiplexes incoming packets to ``handle_event(key, event)``.
"""

from __future__ import annotations

import abc
import heapq
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

Message = Tuple[Any, Any]  # (destination node id, packet)


def _task_lock(task: "ProtocolTask") -> threading.RLock:
    """Per-task lock, created lazily (tasks are plain objects; the executor
    owns their mutual exclusion)."""
    lock = getattr(task, "_pt_lock", None)
    if lock is None:
        lock = task.__dict__.setdefault("_pt_lock", threading.RLock())
    return lock


class ProtocolTask(abc.ABC):
    """One keyed workflow step.

    ``start()`` returns the initial messages; ``restart()`` (default: same as
    start) re-emits them on every period until done.  ``handle(event)``
    consumes one routed event and returns ``(messages, done)``.
    """

    #: restart period; the reference's default is 60s with most epoch tasks
    #: overriding to a few seconds — control-plane RPCs here are local, so
    #: default much lower.
    period_s: float = 2.0
    #: give up after this many restarts (None = forever).  The reference's
    #: ThresholdProtocolTask similarly caps retries for garbage collection.
    max_restarts: Optional[int] = None

    @property
    @abc.abstractmethod
    def key(self) -> str:
        """Unique task key, e.g. ``"WaitAckStopEpoch:name:epoch"``."""

    @abc.abstractmethod
    def start(self) -> List[Message]:
        ...

    def restart(self) -> List[Message]:
        return self.start()

    @abc.abstractmethod
    def handle(self, event: Any) -> Tuple[List[Message], bool]:
        ...

    def on_done(self) -> None:
        """Hook invoked (on the scheduler/handler thread) when the task
        completes or exhausts max_restarts."""


class ProtocolExecutor:
    """Keyed registry + restart scheduler.

    ``send`` is a callable ``(dest, packet) -> None`` (the messenger).
    """

    def __init__(self, send, name: str = "pe"):
        self._send = send
        self._name = name
        self._tasks: Dict[str, ProtocolTask] = {}
        self._restarts: Dict[str, int] = {}
        self._heap: list = []  # (deadline, seq, key, task)
        self._seq = 0
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._stopped = False
        self._thread = threading.Thread(
            target=self._run, name=f"{name}-scheduler", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------------ public
    def schedule(self, task: ProtocolTask) -> bool:
        """Register and start a task; False if the key is already live
        (the reference's ``schedule`` is likewise idempotent by key)."""
        with self._lock:
            if self._stopped or task.key in self._tasks:
                return False
            self._tasks[task.key] = task
            self._restarts[task.key] = 0
            self._push(task.key, task, task.period_s)
        self._emit(task.start())
        return True

    def is_running(self, key: str) -> bool:
        with self._lock:
            return key in self._tasks

    def cancel(self, key: str) -> bool:
        with self._lock:
            self._restarts.pop(key, None)
            return self._tasks.pop(key, None) is not None

    def handle_event(self, key: str, event: Any) -> bool:
        """Route one event to the task registered under ``key``.

        Returns False if no such task (stale reply — normal, dropped).
        ``task.handle`` runs under the task's own lock, so concurrent
        deliveries for one key serialize (the reference synchronizes on the
        task object the same way)."""
        with self._lock:
            task = self._tasks.get(key)
        if task is None:
            return False
        # lock order everywhere: task lock outer, registry lock inner
        with _task_lock(task):
            with self._lock:
                if self._tasks.get(key) is not task:
                    return False  # completed/canceled while we waited
            msgs, done = task.handle(event)
            if done:
                # atomic done-transition under the task lock; a concurrent
                # cancel() may have removed the task already, in which case
                # the canceler wins and on_done must not fire
                with self._lock:
                    popped = self._tasks.pop(key, None)
                    self._restarts.pop(key, None)
                if popped is task:
                    task.on_done()
        self._emit(msgs)
        return True

    def pending(self) -> List[str]:
        with self._lock:
            return sorted(self._tasks)

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._tasks.clear()
            self._cv.notify_all()
        self._thread.join(timeout=5)

    # ----------------------------------------------------------------- private
    def _emit(self, msgs: List[Message]) -> None:
        for dest, packet in msgs:
            self._send(dest, packet)

    def _push(self, key: str, task: "ProtocolTask", delay: float) -> None:
        # the task identity in the entry makes stale timers (from a canceled
        # registration whose key was reused) self-invalidating
        self._seq += 1
        heapq.heappush(
            self._heap, (time.monotonic() + delay, self._seq, key, task)
        )
        self._cv.notify_all()

    def _run(self) -> None:
        while True:
            fire: Optional[ProtocolTask] = None
            expired: Optional[ProtocolTask] = None
            with self._cv:
                if self._stopped:
                    return
                if not self._heap:
                    self._cv.wait(timeout=0.5)
                    continue
                deadline, _, key, task = self._heap[0]
                now = time.monotonic()
                if deadline > now:
                    self._cv.wait(timeout=deadline - now)
                    continue
                heapq.heappop(self._heap)
                if self._tasks.get(key) is not task:
                    continue  # stale entry: canceled/completed registration
                self._restarts[key] = self._restarts.get(key, 0) + 1
                if (
                    task.max_restarts is not None
                    and self._restarts[key] > task.max_restarts
                ):
                    expired = task
                else:
                    fire = task
                    self._push(key, task, task.period_s)
            if fire is not None:
                try:
                    with _task_lock(fire):
                        with self._lock:
                            still_live = self._tasks.get(key) is fire
                        # a task completed between the heap pop and here must
                        # not re-emit its requests ("restarted until done")
                        msgs = fire.restart() if still_live else []
                    self._emit(msgs)
                except Exception:  # task bugs must not kill the scheduler
                    pass
            elif expired is not None:
                try:
                    with _task_lock(expired):
                        with self._lock:
                            live = self._tasks.get(key) is expired
                            if live:
                                self._tasks.pop(key, None)
                                self._restarts.pop(key, None)
                        if live:
                            expired.on_done()
                except Exception:
                    pass


class ThresholdProtocolTask(ProtocolTask):
    """Wait for replies from a threshold of a fixed node set.

    Mirrors ``ThresholdProtocolTask`` + ``WaitforUtility``
    (``paxosutil/WaitforUtility.java:34-68``): tracks distinct responders,
    fires ``on_threshold`` exactly once when ``heard >= threshold``.

    Subclasses implement ``make_request(node)`` (the per-node message) and
    ``on_threshold(replies)`` returning the follow-up messages.  Events must
    expose the responding node via ``sender_of(event)``.
    """

    def __init__(self, nodes, threshold: Optional[int] = None):
        self.nodes = list(nodes)
        self.threshold = (
            threshold if threshold is not None else len(self.nodes) // 2 + 1
        )
        self.replies: Dict[Any, Any] = {}
        self._fired = False

    @abc.abstractmethod
    def make_request(self, node) -> Any:
        ...

    @abc.abstractmethod
    def on_threshold(self, replies: Dict[Any, Any]) -> List[Message]:
        ...

    def sender_of(self, event: Any):
        if isinstance(event, dict):
            return event.get("sender")
        return getattr(event, "sender", None)

    def start(self) -> List[Message]:
        return [(n, self.make_request(n)) for n in self.nodes]

    def restart(self) -> List[Message]:
        # only re-poll nodes not yet heard from (the reference retries the
        # whole multicast; polling the stragglers is strictly cheaper)
        return [
            (n, self.make_request(n)) for n in self.nodes if n not in self.replies
        ]

    def handle(self, event: Any) -> Tuple[List[Message], bool]:
        sender = self.sender_of(event)
        if sender is None or sender not in self.nodes:
            return [], False
        self.replies[sender] = event
        if not self._fired and len(self.replies) >= self.threshold:
            self._fired = True
            return self.on_threshold(dict(self.replies)), True
        return [], False
