"""Placement-override table: explicit exceptions over the hash ring.

The consistent-hash ring (reconfiguration/consistent_hashing.py) is the
*default* placement function — any node can compute a name's servers with no
directory.  Demand-driven migration breaks that purity: a migrated name
lives where the rebalancer put it, not where it hashes.  This table is the
directory for exactly those exceptions: lookups fall through to the ring
when no override exists, so the table stays O(migrated names), not O(names).

Durability rides the replicated reconfigurator DB (rc_db.py): overrides
serialize into the special ``_PLACEMENT`` record's ``rc_epochs`` field — the
record's generic str->int map — via ``placement_set`` / ``placement_clear``
commands, so every RC replica derives the identical table from the committed
command stream and it survives checkpoint/restore like any other record.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from ..reconfiguration.consistent_hashing import ConsistentHashRing

#: the special rc_db record that carries the override map (one per plane,
#: replicated on every reconfigurator like the NC records)
PLACEMENT_RECORD = "_PLACEMENT"

#: key prefix distinguishing cell overrides from shard overrides inside the
#: same ``rc_epochs`` map ("c:<service>" -> packed (host shard, cell))
CELL_KEY_PREFIX = "c:"
#: key prefix carrying a name's consensus MODE bit ("m:<service>" -> 1 for
#: register mode, RMWPaxos).  The bit travels with the placement
#: record so create/migrate on ANY node lands the group in the right plane:
#: a migration target consults mode_of() before create_paxos_instance, and
#: row-targeted creates (OP_CREATE_AT) re-derive it from the row index —
#: the composite row space makes ``row >= G`` the same bit.
MODE_KEY_PREFIX = "m:"
#: packing stride for (host shard, cell) into one int: value =
#: shard * stride + cell — 256 cells per host is far above any core count
CELL_STRIDE = 256


def pack_host_cell(shard: int, cell: int) -> int:
    """Encode a (host shard, serving cell) pair into one rc_epochs int."""
    if not (0 <= cell < CELL_STRIDE):
        raise ValueError(f"cell {cell} out of range [0, {CELL_STRIDE})")
    return int(shard) * CELL_STRIDE + int(cell)


def unpack_host_cell(packed: int) -> tuple:
    """Inverse of :func:`pack_host_cell` -> (shard, cell)."""
    return int(packed) // CELL_STRIDE, int(packed) % CELL_STRIDE


class PlacementTable:
    """name -> destination shard overrides, layered over a hash ring.

    ``shard_of(name)`` is the routing function the edges consult: the
    override when one exists, else the ring default.  For server-list
    routing (``lookup``), an override reorders the ring's replica set so
    the overridden shard's server leads — traffic converges to the new
    placement while the full replica set stays reachable.
    """

    def __init__(self, ring: ConsistentHashRing,
                 shard_of_server: Optional[Dict[str, int]] = None):
        self.ring = ring
        #: server id -> shard index (identity layout: server i owns shard i);
        #: deployments with a different mapping pass their own.
        self.shard_of_server = shard_of_server or {
            s: i for i, s in enumerate(ring.nodes)
        }
        self._server_of_shard = {v: k for k, v in self.shard_of_server.items()}
        self.overrides: Dict[str, int] = {}
        #: name -> (host shard, serving cell) for names whose group was
        #: migrated across cells (cells/migrator.py); absent = static
        #: ``cell_of`` hash placement
        self.cell_overrides: Dict[str, tuple] = {}
        #: names pinned to register (RMW) consensus mode; absent = log mode
        self.register_modes: set = set()
        #: version counter, bumped on every override change and adopted from
        #: the ``_PLACEMENT`` record's epoch — clients key their route-cache
        #: invalidation off it (client._route)
        self.epoch = 0

    # ------------------------------------------------------------- overrides
    def set_override(self, name: str, shard: int) -> None:
        self.overrides[name] = int(shard)
        self.epoch += 1

    def clear_override(self, name: str) -> None:
        if self.overrides.pop(name, None) is not None:
            self.epoch += 1

    def set_cell_override(self, name: str, shard: int, cell: int) -> None:
        self.cell_overrides[name] = (int(shard), int(cell))
        self.epoch += 1

    def clear_cell_override(self, name: str) -> None:
        if self.cell_overrides.pop(name, None) is not None:
            self.epoch += 1

    def cell_of_name(self, name: str) -> Optional[tuple]:
        """The (host shard, cell) a migrated name now lives in, or None for
        default hash placement."""
        return self.cell_overrides.get(name)

    def set_mode(self, name: str, register: bool = True) -> None:
        """Pin ``name``'s consensus mode (register vs log).  The bit must
        be set BEFORE the group is created and never changes afterwards —
        modes don't mix within a group, so a migrating group re-creates in
        the same plane on its destination."""
        if register:
            self.register_modes.add(name)
        else:
            self.register_modes.discard(name)
        self.epoch += 1

    def clear_mode(self, name: str) -> None:
        if name in self.register_modes:
            self.register_modes.discard(name)
            self.epoch += 1

    def mode_of(self, name: str) -> bool:
        """True when ``name`` runs in register (RMW) mode."""
        return name in self.register_modes

    def default_shard(self, name: str) -> int:
        primary = self.ring.primary(name)
        return self.shard_of_server.get(primary, 0)

    def shard_of(self, name: str) -> int:
        ov = self.overrides.get(name)
        return self.default_shard(name) if ov is None else ov

    # --------------------------------------------------------------- routing
    def lookup(self, name: str, k: int = 3) -> List[str]:
        """The k servers for ``name``: the ring's answer verbatim when no
        override exists; with one, the override shard's server is promoted
        to the front (clients hit the new home first, the rest of the ring
        set stays as fallback)."""
        servers = self.ring.replicated_servers(name, k)
        ov = self.overrides.get(name)
        if ov is None:
            return servers
        lead = self._server_of_shard.get(ov)
        if lead is None:
            return servers
        return [lead] + [s for s in servers if s != lead][: max(k - 1, 0)]

    def lead_server(self, name: str) -> Optional[str]:
        """The overridden name's new home server — None when the name has
        no override (route by the ring / RC answer) or the override's shard
        has no server in this layout."""
        ov = self.overrides.get(name)
        return None if ov is None else self._server_of_shard.get(ov)

    def order_actives(self, name: str, actives: Sequence[str]) -> List[str]:
        """Reorder an arbitrary server list so an overridden name's new
        home leads (edge routing: DNS answer order / REQ_ACTIVES order).
        No override, or the override's server absent: verbatim."""
        ov = self.overrides.get(name)
        if ov is None:
            return list(actives)
        lead = self._server_of_shard.get(ov)
        if lead is None or lead not in actives:
            return list(actives)
        return [lead] + [a for a in actives if a != lead]

    # ------------------------------------------------------ rc_db integration
    def to_command(self, name: str) -> dict:
        """The committed command installing ``name``'s current override
        (``placement_clear`` when none)."""
        ov = self.overrides.get(name)
        if ov is None:
            return {"op": "placement_clear", "name": PLACEMENT_RECORD,
                    "service": name}
        return {"op": "placement_set", "name": PLACEMENT_RECORD,
                "service": name, "shard": ov}

    def to_cell_command(self, name: str) -> dict:
        """The committed command installing ``name``'s current cell override
        (``placement_clear_cell`` when none)."""
        ov = self.cell_overrides.get(name)
        if ov is None:
            return {"op": "placement_clear_cell", "name": PLACEMENT_RECORD,
                    "service": name}
        return {"op": "placement_set_cell", "name": PLACEMENT_RECORD,
                "service": name, "shard": ov[0], "cell": ov[1]}

    def to_mode_command(self, name: str) -> dict:
        """The committed command installing ``name``'s current mode bit
        (``placement_clear_mode`` for default log mode)."""
        if name in self.register_modes:
            return {"op": "placement_set_mode", "name": PLACEMENT_RECORD,
                    "service": name}
        return {"op": "placement_clear_mode", "name": PLACEMENT_RECORD,
                "service": name}

    def load_record(self, record_dict: Optional[dict]) -> None:
        """Adopt the override maps from a ``_PLACEMENT`` record dict (as
        produced by ``ReconfigurationRecord.to_dict`` after rc_db applied
        placement commands); None/missing clears.  Cell overrides live in
        the same rc_epochs map under ``c:``-prefixed keys and mode bits
        under ``m:``-prefixed keys; the record's epoch becomes the table's
        version counter so client route caches invalidate on adoption."""
        self.overrides = {}
        self.cell_overrides = {}
        self.register_modes = set()
        rec = record_dict or {}
        for n, s in rec.get("rc_epochs", {}).items():
            n = str(n)
            if n.startswith(CELL_KEY_PREFIX):
                self.cell_overrides[n[len(CELL_KEY_PREFIX):]] = \
                    unpack_host_cell(int(s))
            elif n.startswith(MODE_KEY_PREFIX):
                if int(s):
                    self.register_modes.add(n[len(MODE_KEY_PREFIX):])
            else:
                self.overrides[n] = int(s)
        self.epoch = int(rec.get("epoch", self.epoch + 1))

    def splice(self, ring: ConsistentHashRing,
               shard_of_server: Optional[Dict[str, int]] = None) -> None:
        """Adopt a new ring (node add/remove) keeping the overrides: an
        override pins a name regardless of where the new ring hashes it."""
        self.ring = ring
        self.shard_of_server = shard_of_server or {
            s: i for i, s in enumerate(ring.nodes)
        }
        self._server_of_shard = {v: k for k, v in self.shard_of_server.items()}


def apply_placement_command(records: dict, cmd: dict, make_record) -> dict:
    """rc_db apply-helper for ``placement_set`` / ``placement_clear``.

    Lives here (not in rc_db) so the table format has one home; rc_db calls
    it from its deterministic ``_apply``.  ``records`` is the DB's record
    map, ``make_record`` builds a fresh ReconfigurationRecord.  The override
    map rides the ``_PLACEMENT`` record's ``rc_epochs`` (its generic
    str->int field), so checkpoint/restore and record_install carry it with
    zero record-schema changes.
    """
    rec = records.get(PLACEMENT_RECORD)
    if rec is None:
        rec = records[PLACEMENT_RECORD] = make_record(PLACEMENT_RECORD)
    service = cmd.get("service", "")
    if not service:
        return {"ok": False, "error": "no_service"}
    op = cmd["op"]
    if op == "placement_set":
        rec.rc_epochs[service] = int(cmd["shard"])
    elif op == "placement_clear":
        rec.rc_epochs.pop(service, None)
    elif op == "placement_set_cell":
        rec.rc_epochs[CELL_KEY_PREFIX + service] = pack_host_cell(
            int(cmd.get("shard", 0)), int(cmd["cell"])
        )
    elif op == "placement_clear_cell":
        rec.rc_epochs.pop(CELL_KEY_PREFIX + service, None)
    elif op == "placement_set_mode":
        rec.rc_epochs[MODE_KEY_PREFIX + service] = 1
    elif op == "placement_clear_mode":
        rec.rc_epochs.pop(MODE_KEY_PREFIX + service, None)
    else:
        return {"ok": False, "error": "bad_op"}
    rec.epoch += 1  # version counter, mirrors the NC records
    return {"ok": True, "overrides": dict(rec.rc_epochs), "epoch": rec.epoch}
