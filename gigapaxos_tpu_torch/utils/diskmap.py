"""Demand-paged map: a dict whose cold entries live on disk.

Analog of ``utils/DiskMap.java:97`` (used by the reference's logger for the
message-log index and by pause state): a memory map with a bounded hot set;
entries evicted from RAM are written to disk and transparently paged back
on access.  The dense framework uses it for the pause/spill store — a node
can hold orders of magnitude more *paused* groups than device rows or host
RAM would allow (``PaxosManager.java:2284-2365`` pause analog).

Layout: one record file per key under ``dir_path`` (typed binary codec,
wal/records.py — nothing executable on any replay path; keys hash to
filenames; collisions resolved by storing the key alongside the value).
Thread-safe via one lock — callers are host control-plane paths, not the
device hot loop.
"""

from __future__ import annotations

import collections
import hashlib
import os

import threading
from typing import Any, Iterator, Optional

from ..wal import records


class DiskMap:
    """dict-like with an LRU RAM cache of ``cache_cap`` entries; the rest
    pages to ``dir_path``.  ``None`` dir keeps everything in RAM (the map
    degrades to a plain bounded-cache-less dict)."""

    def __init__(self, dir_path: Optional[str] = None, cache_cap: int = 1024):
        self.dir = dir_path
        self.cache_cap = max(cache_cap, 1)
        if dir_path is not None:
            os.makedirs(dir_path, exist_ok=True)
        self._hot: "collections.OrderedDict[str, Any]" = collections.OrderedDict()
        #: keys currently resident on disk (superset check avoids stat calls)
        self._cold: set = set()
        self._lock = threading.Lock()
        if dir_path is not None:
            for fn in os.listdir(dir_path):
                if fn.endswith(".rec"):
                    try:
                        with open(os.path.join(dir_path, fn), "rb") as f:
                            key, _ = records.loads(f.read())
                        self._cold.add(key)
                    except Exception:
                        continue  # torn file: treated as absent

    # ------------------------------------------------------------- disk I/O
    def _path(self, key: str) -> str:
        h = hashlib.blake2b(key.encode(), digest_size=12).hexdigest()
        return os.path.join(self.dir, f"{h}.rec")

    def _page_out(self, key: str, value: Any) -> None:
        path = self._path(key)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(records.dumps((key, value)))
        os.replace(tmp, path)
        self._cold.add(key)

    def _page_in(self, key: str) -> Any:
        with open(self._path(key), "rb") as f:
            stored_key, value = records.loads(f.read())
        if stored_key != key:
            raise KeyError(key)  # hash collision with a different key
        return value

    def _evict_if_needed(self) -> None:
        while len(self._hot) > self.cache_cap and self.dir is not None:
            old_key, old_val = self._hot.popitem(last=False)
            self._page_out(old_key, old_val)

    # ----------------------------------------------------------- dict-alike
    def __setitem__(self, key: str, value: Any) -> None:
        with self._lock:
            self._hot[key] = value
            self._hot.move_to_end(key)
            if self.dir is not None and key in self._cold:
                # stale disk copy must not resurrect on a later page-in
                try:
                    os.unlink(self._path(key))
                except OSError:
                    pass
                self._cold.discard(key)
            self._evict_if_needed()

    def __getitem__(self, key: str) -> Any:
        with self._lock:
            if key in self._hot:
                self._hot.move_to_end(key)
                return self._hot[key]
            if key in self._cold:
                value = self._page_in(key)
                self._cold.discard(key)
                try:
                    os.unlink(self._path(key))
                except OSError:
                    pass
                self._hot[key] = value
                self._evict_if_needed()
                return value
        raise KeyError(key)

    def get(self, key: str, default: Any = None) -> Any:
        try:
            return self[key]
        except KeyError:
            return default

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._hot or key in self._cold

    def __delitem__(self, key: str) -> None:
        with self._lock:
            found = False
            if key in self._hot:
                del self._hot[key]
                found = True
            if key in self._cold:
                try:
                    os.unlink(self._path(key))
                except OSError:
                    pass
                self._cold.discard(key)
                found = True
            if not found:
                raise KeyError(key)

    def pop(self, key: str, *default: Any) -> Any:
        try:
            value = self[key]
        except KeyError:
            if default:
                return default[0]
            raise
        del self[key]
        return value

    def __len__(self) -> int:
        with self._lock:
            return len(self._hot) + len(self._cold)

    def __iter__(self) -> Iterator[str]:
        with self._lock:
            return iter(list(self._hot) + list(self._cold))

    def keys(self):
        return iter(self)

    def peek(self, key: str) -> Any:
        """Non-destructive read: a cold entry stays on disk (no unlink, no
        LRU churn) — the snapshot path iterates the whole map and must not
        rewrite the entire cold tier doing so."""
        with self._lock:
            if key in self._hot:
                return self._hot[key]
            if key in self._cold:
                return self._page_in(key)
        raise KeyError(key)

    def clear(self) -> None:
        """Drop everything, disk copies included (recovery loads the
        snapshot's paused set as the sole authority)."""
        with self._lock:
            self._hot.clear()
            if self.dir is not None:
                for key in list(self._cold):
                    try:
                        os.unlink(self._path(key))
                    except OSError:
                        pass
            self._cold.clear()

    def update(self, other) -> None:
        for k in other:
            self[k] = other[k]

    def hot_count(self) -> int:
        with self._lock:
            return len(self._hot)

    def cold_count(self) -> int:
        with self._lock:
            return len(self._cold)
