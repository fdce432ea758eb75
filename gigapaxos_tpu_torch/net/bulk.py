"""Chunked bulk transfer over the node transport.

Analog of ``paxosutil/LargeCheckpointer.java:39`` + the fragmentation idea of
``PrepareReplyAssembler.java`` (SURVEY §2.1): big blobs — epoch-final
checkpoints above the inline threshold — must not ride a single frame (the
transport hard-caps frames, and one giant frame head-of-line-blocks every
control packet behind it).  The reference writes huge checkpoints to files
and passes handles fetched out of band; here the out-of-band channel is the
same TCP link using raw-bytes frames, chunked and reassembled by key.

Wire format of a chunk frame (KIND_BYTES payload):

    b"GPBK" | u16 key_len | key utf-8 | u32 index | u32 n_chunks | data

Keys are transfer-scoped (e.g. ``efs:alice:3``); receivers register a
completion callback per key prefix or rely on the default handler.  Chunks
may interleave with other keys' chunks and with control frames.
"""

from __future__ import annotations

import struct
import threading
import time
from typing import Callable, Dict, Optional, Tuple

MAGIC = b"GPBK"
_HDR = struct.Struct(">HII")  # key_len is packed separately for alignment
DEFAULT_CHUNK = 1 << 20  # 1 MiB


class BulkTransfer:
    """Per-messenger bulk send/receive endpoint.

    Attach one per Messenger; it claims the demux's raw-bytes handler.
    ``on_complete(sender, key, data)`` fires on the reader thread when all
    chunks of a key arrived.
    """

    def __init__(self, messenger,
                 on_complete: Optional[Callable[[str, str, bytes], None]] = None,
                 chunk_size: int = DEFAULT_CHUNK,
                 max_inflight_bytes: int = 1 << 30,
                 partial_ttl_s: float = 60.0,
                 pace_every_bytes: int = 32 << 20,
                 pace_sleep_s: float = 0.01):
        self.m = messenger
        self.chunk_size = chunk_size
        self.max_inflight_bytes = max_inflight_bytes
        self.partial_ttl_s = partial_ttl_s
        self.pace_every_bytes = pace_every_bytes
        self.pace_sleep_s = pace_sleep_s
        self._on_complete = on_complete
        self._lock = threading.Lock()
        #: (sender, key) -> [n_chunks, {idx: bytes}, total_bytes, last_seen]
        self._rx: Dict[Tuple[str, str], list] = {}
        self._handlers: Dict[str, Callable[[str, str, bytes], None]] = {}
        messenger.demux.bytes_handler = self._on_bytes

    def register_prefix(self, prefix: str,
                        handler: Callable[[str, str, bytes], None]) -> None:
        """Route completed transfers whose key starts with ``prefix``."""
        self._handlers[prefix] = handler

    # ------------------------------------------------------------------ send
    def send(self, dest: str, key: str, data: bytes) -> int:
        """Chunk ``data`` to ``dest`` under ``key``; returns chunk count.

        Paced: without the periodic sleep, a multi-GB state would be copied
        wholesale into the outbound queue (and block the calling thread on
        queue backpressure); pacing bounds the resident burst and leaves
        gaps for control frames.  Call from a worker thread for big states —
        see ActiveReplica's final-state path."""
        kb = key.encode()
        n = max(1, (len(data) + self.chunk_size - 1) // self.chunk_size)
        since_pace = 0
        for i in range(n):
            piece = data[i * self.chunk_size:(i + 1) * self.chunk_size]
            frame = (MAGIC + struct.pack(">H", len(kb)) + kb
                     + struct.pack(">II", i, n) + piece)
            self.m.send_bytes(dest, frame)
            since_pace += len(piece)
            if since_pace >= self.pace_every_bytes:
                since_pace = 0
                time.sleep(self.pace_sleep_s)
        return n

    # --------------------------------------------------------------- receive
    def _on_bytes(self, sender: str, payload: bytes) -> None:
        if not payload.startswith(MAGIC):
            return
        off = len(MAGIC)
        (klen,) = struct.unpack_from(">H", payload, off)
        off += 2
        key = payload[off: off + klen].decode()
        off += klen
        idx, n = struct.unpack_from(">II", payload, off)
        off += 8
        data = payload[off:]
        done: Optional[bytes] = None
        now = time.monotonic()
        with self._lock:
            # GC stale partials (dead sender mid-stream, or leftover chunks
            # of a duplicate resend whose first copy already completed) —
            # without this each pins up to the full state size forever
            stale = [k for k, e in self._rx.items()
                     if now - e[3] > self.partial_ttl_s]
            for k in stale:
                del self._rx[k]
            if idx >= n:
                # out-of-range chunk (corrupt/stray datagram): drop before
                # touching the receive table — it must neither allocate an
                # entry (spoofed unique keys would grow _rx until TTL GC),
                # enter the chunk map (len(chunks)==n could then hold with a
                # real index missing, wedging the completion join), nor
                # reset an in-progress transfer
                return
            ent = self._rx.get((sender, key))
            if ent is None:
                ent = self._rx[(sender, key)] = [n, {}, 0, now]
            if ent[0] != n:
                # restarted transfer with different chunking: start over
                ent = self._rx[(sender, key)] = [n, {}, 0, now]
            if idx not in ent[1]:
                ent[1][idx] = data
                ent[2] += len(data)
            ent[3] = now
            # backpressure: a sender flooding partial transfers is bounded
            if ent[2] > self.max_inflight_bytes:
                del self._rx[(sender, key)]
                return
            if len(ent[1]) == n:
                done = b"".join(ent[1][i] for i in range(n))
                del self._rx[(sender, key)]
        if done is not None:
            for prefix, h in self._handlers.items():
                if key.startswith(prefix):
                    h(sender, key, done)
                    return
            if self._on_complete is not None:
                self._on_complete(sender, key, done)

    def pending(self) -> int:
        with self._lock:
            return len(self._rx)
