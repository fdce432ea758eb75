"""Name <-> dense-row interning.

Every paxos group name gets a row index into the ``[G]`` state tensors;
freed rows are recycled (LIFO, so a workload's row assignment is a
deterministic function of its create/free sequence).
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional


class RowAllocator:
    """Allocates dense row indices for string names, with recycling."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._name_to_row: Dict[str, int] = {}
        self._row_to_name: Dict[int, str] = {}
        self._free: list[int] = list(range(capacity - 1, -1, -1))

    def __len__(self) -> int:
        return len(self._name_to_row)

    def __contains__(self, name: str) -> bool:
        return name in self._name_to_row

    def full(self) -> bool:
        return not self._free

    def free_count(self) -> int:
        return len(self._free)

    def alloc(self, name: str) -> int:
        if name in self._name_to_row:
            raise KeyError(f"{name!r} already allocated")
        if not self._free:
            raise MemoryError(
                f"group table full ({self.capacity}); raise paxos.max_groups")
        row = self._free.pop()
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
        self._free.append(row)
        return row

    def names(self) -> Iterator[str]:
        return iter(self._name_to_row)

    def items(self):
        return self._name_to_row.items()

    def snapshot_free_rows(self) -> list:
        """The free-list in verbatim LIFO order (the snapshot format)."""
        return list(self._free)

    def restore(self, rows: Dict[str, int], free_rows=None) -> None:
        """Reset to a snapshot: name->row map plus the VERBATIM free-list.

        The LIFO order of ``free_rows`` must survive recovery — journal
        replay re-allocates rows with ``pop()`` and row-addressed tick
        records only land correctly if replay allocates the same rows the
        live run did.  ``free_rows=None`` (snapshots without a free list)
        reconstructs best-effort in the initial descending order.  A free
        list of a partitioned allocator (register rows past ``capacity``)
        is refused: register groups come with a later slice of the port.
        """
        if free_rows is not None and any(r >= self.capacity
                                         for r in free_rows):
            raise NotImplementedError(
                "register-plane rows in the snapshot's free list (the "
                "register slice of the port)")
        self._name_to_row = dict(rows)
        self._row_to_name = {row: name for name, row in rows.items()}
        if free_rows is not None:
            self._free = list(free_rows)
        else:
            used = set(rows.values())
            self._free = [r for r in range(self.capacity - 1, -1, -1)
                          if r not in used]
