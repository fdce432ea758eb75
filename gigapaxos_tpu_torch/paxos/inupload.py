"""The Mode A inbox's upload to the device: one tick's placements, packed.

A tick's inbox is ``[R, P, G]`` request ids and stop flags, nearly all
zero: a tick places thousands of requests into millions of slots.  The host
packs the placements as int32 columns (the flat slot
``(entry * P + p) * G + row``, the rid, the stop), the ``[R]`` liveness
bytes and the device app's used descriptor prefix into one host buffer and
copies that to the device.  There one zeroed block holds the inbox and the
``[4, K]`` descriptor columns, the placements are scattered in
(``gp_scatter_inbox``; on the CPU its plain version, ``index_put_``) and
the descriptor prefix copied: bit for bit the dense build's inbox.  Few
calls lie between the upload timer's events, since the device waits for
the host between them.

On a CUDA device the buffers are pinned, two used in turn, and the copy is
``non_blocking`` on the tick's stream, so the upload never waits for the
device.  Before a buffer is written again the host waits on the event
recorded after its last copy, two ticks before.  A buffer grows, to the
next power of two, only when a tick needs more."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..obs.metrics import registry
from ..ops import plane_gather
from ..ops.tick import TickInbox


class StagedInbox(NamedTuple):
    """Views of one host buffer, for the host to fill: int32 ``flat``,
    ``rid`` and ``stop`` ``[n]``, uint8 ``alive`` ``[R]`` and int32
    ``desc`` ``[4, o]`` (rids, ops, keys, values)."""

    flat: np.ndarray
    rid: np.ndarray
    stop: np.ndarray
    alive: np.ndarray
    desc: np.ndarray


class InboxUploader:
    """The ring of host buffers and the device build of one manager's
    inbox of ``shape`` ``(R, P, G)`` on ``device``.  :meth:`stage` hands
    out the next buffer's views, :meth:`send` uploads them; every upload's
    bytes count into ``inbox_upload_bytes_total{driver=,plane=}``."""

    #: the smallest buffer, in int32 words
    MIN_WORDS = 1 << 12

    def __init__(self, driver: str, plane: str, shape, device):
        R, P, G = shape
        if R * P * G >= 2**31:
            raise ValueError(f"an inbox of {R * P * G} slots: flat slot "
                             "indices must fit int32")
        self.shape = (R, P, G)
        self._slots = R * P * G
        self.device = device
        self._alive_words = (R + 3) // 4
        self._cuda = device.type == "cuda"
        self._ring = [None, None]  # per turn: (tensor, ndarray)
        self._sent = [None, None]  # per turn: event after its last copy
        self._turn = 0
        self._n = self._o = 0
        self._bytes = registry().counter(
            "inbox_upload_bytes_total",
            help="bytes of the Mode A inbox's uploads to the device",
            driver=driver, plane=plane)

    def stage(self, n: int, o: int) -> StagedInbox:
        """The next buffer of the ring, for ``n`` placements and ``o``
        descriptors, once its last copy has read it."""
        self._turn ^= 1
        t = self._turn
        if self._sent[t] is not None:
            self._sent[t].synchronize()
        aw, a0 = self._alive_words, 3 * n
        words = a0 + aw + 4 * o
        buf = self._ring[t]
        if buf is None or buf[1].size < words:
            cap = max(self.MIN_WORDS, 1 << (words - 1).bit_length())
            tensor = torch.empty(cap, dtype=torch.int32,
                                 pin_memory=self._cuda)
            buf = self._ring[t] = (tensor, tensor.numpy())
        self._n, self._o = n, o
        a = buf[1]
        return StagedInbox(a[:n], a[n:2 * n], a[2 * n:a0],
                           a[a0:a0 + aw].view(np.uint8)[:self.shape[0]],
                           a[a0 + aw:words].reshape(4, o))

    def send(self, timers, kv_width=None):
        """Upload the staged buffer; returns the device ``TickInbox`` and,
        for a ``kv_width``, the four ``[kv_width]`` descriptor columns
        (zero past the staged prefix), else None.  A flat slot outside the
        inbox raises ValueError before anything is copied, on every
        device.  The copy, the zeroing,
        the scatter and the padding are timed as ``timers``' "upload"
        (``obs.phase.device_timers``)."""
        R, aw = self.shape[0], self._alive_words
        n, o, t = self._n, self._o, self._turn
        a0 = 3 * n
        src = self._ring[t][0][:a0 + aw + 4 * o]
        dev, slots = self.device, self._slots
        flat = self._ring[t][1][:n]
        if n and (flat.min() < 0 or flat.max() >= slots):
            raise ValueError(f"a placement's flat slot lies outside [0, "
                             f"{slots}): {flat.min()}..{flat.max()}")
        kv_bytes = 16 * (kv_width or 0)
        t0 = timers.start()
        if self._cuda:
            d = src.to(dev, non_blocking=True)
            if self._sent[t] is None:
                self._sent[t] = torch.cuda.Event()
            self._sent[t].record(torch.cuda.current_stream(dev))
        else:
            d = src.clone()  # the inbox's alive is a view of it
        # one memset: req (int32), the descriptor columns (int32), stp
        z = torch.zeros(5 * slots + kv_bytes, dtype=torch.uint8, device=dev)
        req = z[:4 * slots].view(torch.int32).view(self.shape)
        stp = z[4 * slots + kv_bytes:].view(torch.bool).view(self.shape)
        if n:
            scatter = (plane_gather.scatter_inbox_cuda if self._cuda
                       else plane_gather.scatter_inbox_plain)
            scatter(d[:n], d[n:2 * n], d[2 * n:a0], req, stp)
        alive = d[a0:a0 + aw].view(torch.uint8)[:R].view(torch.bool)
        reg = None
        if kv_width is not None:
            cols = z[4 * slots:4 * slots + kv_bytes].view(torch.int32).view(
                4, kv_width)
            if o:
                cols[:, :o].copy_(d[a0 + aw:].view(4, o))
            reg = tuple(cols.unbind(0))
        timers.stop("upload", t0)
        self._bytes.inc(4 * src.numel())
        return TickInbox(req, stp, alive), reg
