"""The Mode A outbox's device->host copy, started at dispatch.

A tick's packed outbox (one int32 buffer, or a tuple of them, one a plane)
is copied into host buffers kept across ticks: two a tuple position, used
in turn, so tick N+1's copy lands in one while tick N's is read from the
other.  A CUDA buffer is copied into pinned memory on a stream of its own,
after an event that the dispatching stream records behind the tick's work:
the next tick's kernels never queue in front of the copy, and completion
waits for the copy's own event alone.  A CPU buffer is copied at once into
plain host memory, through the same ring."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..obs.phase import device_timers


class LandingOutbox(NamedTuple):
    """One started copy: the host arrays it lands in, the event that marks
    it landed (None: it already has), and the device buffers it reads,
    held until it has."""

    arrays: tuple
    landed: Optional[object]
    source: object
    is_tuple: bool


class OutboxCopier:
    """Two host buffers a tuple position and the copy stream of one
    manager's outbox.  Arrays handed out by :meth:`land` stay valid until
    the :meth:`start` after next.  A CUDA copy is timed on the copy stream
    into ``tick_device_seconds{driver=,plane=,part="copy"}``, with
    ``labels`` (a mesh shard's ``shard``) beside them."""

    def __init__(self, driver: str, plane: str, **labels):
        self._labels = (driver, plane)
        self._extra = labels
        self._ring = ([], [])  # per turn: (tensor, ndarray) a position
        self._events = None    # per turn: (ready, landed)
        self._turn = 0
        self._stream = None
        self._timers = None

    def start(self, packed) -> LandingOutbox:
        """Enqueue the copy of ``packed`` behind the work enqueued so far
        on its device's current stream."""
        is_tuple = isinstance(packed, tuple)
        parts = packed if is_tuple else (packed,)
        cuda = parts[0].device.type == "cuda"
        self._turn ^= 1
        bufs = self._ring[self._turn]
        if [t.shape for t, _ in bufs] != [p.shape for p in parts]:
            # first use, or the outbox's layout changed
            bufs[:] = [(t, t.numpy()) for t in (
                torch.empty(p.shape, dtype=p.dtype, pin_memory=cuda)
                for p in parts)]
        arrays = tuple(a for _, a in bufs)
        if not cuda:
            for (t, _), p in zip(bufs, parts):
                t.copy_(p)
            return LandingOutbox(arrays, None, None, is_tuple)
        dev = parts[0].device
        cs = self._copy_stream(dev)
        ready, landed = self._events[self._turn]
        ready.record(torch.cuda.current_stream(dev))
        cs.wait_event(ready)
        t0 = self._timers.start()
        with torch.cuda.stream(cs):
            for (t, _), p in zip(bufs, parts):
                t.copy_(p, non_blocking=True)
        self._timers.stop("copy", t0)
        landed.record(cs)
        return LandingOutbox(arrays, landed, packed, is_tuple)

    def land(self, out: LandingOutbox):
        """Wait for ``out``'s copy; its host arrays (a tuple for a tuple)."""
        if out.landed is not None:
            out.landed.synchronize()
            self._timers.poll()
        return out.arrays if out.is_tuple else out.arrays[0]

    def _copy_stream(self, dev):
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=dev)
            self._events = tuple((torch.cuda.Event(), torch.cuda.Event())
                                 for _ in range(2))
            self._timers = device_timers(*self._labels, ("copy",), dev,
                                         stream=self._stream, **self._extra)
        return self._stream
