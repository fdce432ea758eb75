"""Per-name reconfiguration records and their epoch-lifecycle state machine.

Analog of ``reconfigurationutils/ReconfigurationRecord.java:32`` with the
``RCStates`` lifecycle (``:53-91``):

    READY --(intent)--> WAIT_ACK_STOP --(acks)--> READY (epoch+1)
    READY --(delete)--> WAIT_DELETE --(drop acks / max age)--> gone

As in the reference, WAIT_ACK_START / READY_READY are compressed away:
reconfiguration is complete once a majority of AckStartEpochs arrive, so the
record jumps from WAIT_ACK_STOP to READY of the next epoch while DropEpoch
garbage collection proceeds lazily.

Records are plain dataclasses serializable to/from JSON dicts — they are the
*application state* of the replicated reconfigurator DB (rc_db.py), mutated
only through deterministic commands so every reconfigurator replica derives
identical records.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


class RCState(str, enum.Enum):
    READY = "READY"
    WAIT_ACK_STOP = "WAIT_ACK_STOP"
    WAIT_DELETE = "WAIT_DELETE"


@dataclass
class ReconfigurationRecord:
    name: str
    epoch: int = 0
    state: RCState = RCState.READY
    actives: List[str] = field(default_factory=list)
    new_actives: List[str] = field(default_factory=list)
    # wall time the delete was initiated (WAIT_DELETE grace, the reference's
    # deleteTime / MAX_FINAL_STATE_AGE wait)
    delete_time: Optional[float] = None
    # RC-epoch bookkeeping for the special NC (node-config) record
    rc_epochs: Dict[str, int] = field(default_factory=dict)
    # NC record only: the ordered replica-slot universe (boot topology +
    # runtime-added nodes in commit order).  Mode B slot indices derive
    # from this order, so it must be identical on every node — it is
    # state of the paxos-replicated NC record, not local configuration.
    universe: List[str] = field(default_factory=list)

    # ------------------------------------------------------------ transitions
    def can_reconfigure(self) -> bool:
        return self.state == RCState.READY

    def set_intent(self, new_actives: List[str]) -> bool:
        """READY -> WAIT_ACK_STOP with the next epoch's target set
        (the WAIT_ACK_STOP RCRecordRequest intent)."""
        if not self.can_reconfigure():
            return False
        self.new_actives = sorted(new_actives)
        self.state = RCState.WAIT_ACK_STOP
        return True

    def set_complete(self) -> bool:
        """WAIT_ACK_STOP -> READY of epoch+1 (majority AckStartEpoch)."""
        if self.state != RCState.WAIT_ACK_STOP:
            return False
        self.epoch += 1
        self.actives = list(self.new_actives)
        self.new_actives = []
        self.state = RCState.READY
        return True

    def set_delete_intent(self, now: Optional[float] = None) -> bool:
        """READY -> WAIT_DELETE (handleDeleteServiceName); the record lingers
        until final state is dropped or ages out."""
        if self.state != RCState.READY:
            return False
        self.state = RCState.WAIT_DELETE
        self.delete_time = time.time() if now is None else now
        return True

    def delete_aged(self, max_final_state_age_s: float, now: Optional[float] = None) -> bool:
        if self.state != RCState.WAIT_DELETE or self.delete_time is None:
            return False
        return ((time.time() if now is None else now) - self.delete_time) >= (
            max_final_state_age_s
        )

    # ----------------------------------------------------------- serialization
    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "epoch": self.epoch,
            "state": self.state.value,
            "actives": list(self.actives),
            "new_actives": list(self.new_actives),
            "delete_time": self.delete_time,
            "rc_epochs": dict(self.rc_epochs),
            "universe": list(self.universe),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ReconfigurationRecord":
        return cls(
            name=d["name"],
            epoch=d["epoch"],
            state=RCState(d["state"]),
            actives=list(d.get("actives", [])),
            new_actives=list(d.get("new_actives", [])),
            delete_time=d.get("delete_time"),
            rc_epochs=dict(d.get("rc_epochs", {})),
            universe=list(d.get("universe", [])),
        )
