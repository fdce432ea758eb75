"""Name <-> dense-row interning.

Every paxos group name gets a row index into the ``[G]`` state tensors;
freed rows are recycled (LIFO, so a workload's row assignment is a
deterministic function of its create/free sequence).
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional


class RowAllocator:
    """Allocates dense row indices for string names, with recycling.

    Optionally PARTITIONED at ``split``: rows ``[0, split)`` are the
    default (log-mode) pool, rows ``[split, capacity)`` the high
    (register-mode) pool, two independent LIFO free-lists.  ``split ==
    capacity`` (the default) is the single-pool allocator, with the same
    pop order and snapshot format.
    """

    def __init__(self, capacity: int, split: Optional[int] = None):
        self.capacity = capacity
        self.split = capacity if split is None else split
        if not (0 <= self.split <= capacity):
            raise ValueError(f"split {split} outside [0, {capacity}]")
        self._name_to_row: Dict[str, int] = {}
        self._row_to_name: Dict[int, str] = {}
        self._free: list[int] = list(range(self.split - 1, -1, -1))
        self._free_hi: list[int] = list(range(capacity - 1, self.split - 1,
                                              -1))

    def __len__(self) -> int:
        return len(self._name_to_row)

    def __contains__(self, name: str) -> bool:
        return name in self._name_to_row

    def full(self, hi: bool = False) -> bool:
        return not (self._free_hi if hi else self._free)

    def free_count(self, hi: bool = False) -> int:
        return len(self._free_hi if hi else self._free)

    def alloc(self, name: str, hi: bool = False) -> int:
        if name in self._name_to_row:
            raise KeyError(f"{name!r} already allocated")
        pool = self._free_hi if hi else self._free
        if not pool:
            raise MemoryError(
                "register row table full "
                f"({self.capacity - self.split}); raise paxos.register_groups"
                if hi else
                f"group table full ({self.split}); raise paxos.max_groups")
        row = pool.pop()
        self._name_to_row[name] = row
        self._row_to_name[row] = name
        return row

    def row(self, name: str) -> Optional[int]:
        return self._name_to_row.get(name)

    def name(self, row: int) -> Optional[str]:
        return self._row_to_name.get(row)

    def free(self, name: str) -> int:
        row = self._name_to_row.pop(name)
        del self._row_to_name[row]
        (self._free if row < self.split else self._free_hi).append(row)
        return row

    def names(self) -> Iterator[str]:
        return iter(self._name_to_row)

    def items(self):
        return self._name_to_row.items()

    def snapshot_free_rows(self) -> list:
        """Both free-lists, low pool first, each in verbatim LIFO order (the
        snapshot format).  ``restore`` re-splits by row index, so the
        concatenation round-trips exactly."""
        return list(self._free) + list(self._free_hi)

    def restore(self, rows: Dict[str, int], free_rows=None) -> None:
        """Reset to a snapshot: name->row map plus the VERBATIM free-list.

        The LIFO order of ``free_rows`` must survive recovery — journal
        replay re-allocates rows with ``pop()`` and row-addressed tick
        records only land correctly if replay allocates the same rows the
        live run did.  ``free_rows=None`` (snapshots without a free list)
        reconstructs best-effort in the initial descending order.
        """
        self._name_to_row = dict(rows)
        self._row_to_name = {row: name for name, row in rows.items()}
        if free_rows is not None:
            self._free = [r for r in free_rows if r < self.split]
            self._free_hi = [r for r in free_rows if r >= self.split]
        else:
            used = set(rows.values())
            self._free = [r for r in range(self.split - 1, -1, -1)
                          if r not in used]
            self._free_hi = [r for r in range(self.capacity - 1,
                                              self.split - 1, -1)
                             if r not in used]
