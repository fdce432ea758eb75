"""Reconfiguration wire schema.

Analog of ``reconfiguration/reconfigurationpackets/`` (SURVEY §2.3): the
control-plane packet vocabulary exchanged between clients, active replicas
and reconfigurators.  The reference defines one Java class per packet type
(``CreateServiceName``, ``StartEpoch``, ``DemandReport``, ...); here packets
are flat JSON dicts with a ``type`` tag (the transport's KIND_JSON frames)
and this module is the single place their field names are defined.

Binary payloads (app requests, epoch-final checkpoints) travel base64-coded
inside the JSON; bulk state beyond that should use the transport's raw-bytes
frames (KIND_BYTES) — the reference draws the same line with
``LargeCheckpointer`` file handles.

Client addressing: clients bind an ephemeral server port and stamp every
request with ``client_addr``; server nodes learn the mapping via
:func:`register_client` before replying (the reference gets this for free
from NIO's connection reuse; our node-addressed transport makes it explicit).
"""

from __future__ import annotations

import base64
from typing import List, Optional

# ---------------------------------------------------------------- type tags
# client <-> reconfigurator
CREATE_SERVICE_NAME = "create_service_name"        # CreateServiceName.java
DELETE_SERVICE_NAME = "delete_service_name"        # DeleteServiceName.java
REQUEST_ACTIVE_REPLICAS = "request_active_replicas"  # RequestActiveReplicas.java
CLIENT_RECONFIGURE = "client_reconfigure"          # explicit migration request
CREATE_RESPONSE = "create_response"
DELETE_RESPONSE = "delete_response"
ACTIVES_RESPONSE = "actives_response"
RECONFIGURE_RESPONSE = "reconfigure_response"

# batched creates: one RC commit per batch per RC group
# (reconfigurationpackets/BatchedCreateServiceName.java)
CREATE_BATCH = "batched_create_service_name"
CREATE_BATCH_RESPONSE = "batched_create_response"

#: pseudo-name resolving the WHOLE active pool (anycast support —
#: ReconfigurableAppClientAsync.ALL_ACTIVES / sendRequestAnycast:1357)
ALL_ACTIVES = "*all_actives*"

# admin <-> reconfigurator (node-config elasticity,
# ReconfigureActiveNodeConfig / Reconfigurator.handleReconfigureRCNodeConfig:1044)
ADD_ACTIVE = "add_active"
REMOVE_ACTIVE = "remove_active"
#: RC-node elasticity (ReconfigureRCNodeConfig,
#: Reconfigurator.handleReconfigureRCNodeConfig:1044)
ADD_RC = "add_reconfigurator"
REMOVE_RC = "remove_reconfigurator"
NODE_CONFIG_RESPONSE = "node_config_response"

# client <-> active replica
APP_REQUEST = "app_request"                        # AppRequest / ReplicableClientRequest
APP_RESPONSE = "app_response"
# lease-era linearizable read: answered locally by a valid
# lease holder, else through a consensus round; the payload must be
# side-effect-free under the app.  Responses reuse APP_RESPONSE.
APP_READ = "app_read"
# many client requests in one frame + one frame of responses back — the
# client-edge RequestBatcher (RequestPacket.java:189-233 `batched[]`,
# RequestBatcher.java:25-60).  Dedup is batch-granular: retransmissions
# reuse the batch id and are absorbed/replayed as a unit.
APP_REQUEST_BATCH = "app_request_batch"
APP_RESPONSE_BATCH = "app_response_batch"
ECHO_REQUEST = "echo_request"                      # ActiveReplica.handleEchoRequest:1126
ECHO_REPLY = "echo_reply"

# reconfigurator <-> active replica (epoch lifecycle,
# reconfigurationpackets/{StopEpoch,StartEpoch,DropEpochFinalState}.java)
STOP_EPOCH = "stop_epoch"
ACK_STOP_EPOCH = "ack_stop_epoch"
START_EPOCH = "start_epoch"
ACK_START_EPOCH = "ack_start_epoch"
DROP_EPOCH = "drop_epoch_final_state"
ACK_DROP_EPOCH = "ack_drop_epoch_final_state"
DEMAND_REPORT = "demand_report"                    # DemandReport.java

# active replica <-> active replica (final-state transfer,
# RequestEpochFinalState.java / EpochFinalState.java)
REQUEST_EPOCH_FINAL_STATE = "request_epoch_final_state"
EPOCH_FINAL_STATE = "epoch_final_state"


# ------------------------------------------------------------------ helpers
def b64e(data: Optional[bytes]) -> Optional[str]:
    return None if data is None else base64.b64encode(data).decode()


def b64d(txt: Optional[str]) -> Optional[bytes]:
    return None if txt is None else base64.b64decode(txt)


def register_client(nodemap, packet: dict) -> None:
    """Teach this node's transport where the packet's sender listens, from
    the ``client_addr`` stamp (no-op for peer nodes already in the map)."""
    addr = packet.get("client_addr")
    sender = packet.get("sender")
    if addr and sender and nodemap(sender) is None:
        nodemap.add(sender, addr[0], int(addr[1]))


# ------------------------------------------------------------- constructors
def create_service_name(name: str, initial_state: bytes, rid: int) -> dict:
    return {
        "type": CREATE_SERVICE_NAME,
        "name": name,
        "initial_state": b64e(initial_state),
        "rid": rid,
    }


def create_batch(creates, rid: int) -> dict:
    """creates: list of (name, initial_state bytes)."""
    return {
        "type": CREATE_BATCH,
        "creates": [
            {"name": n, "initial_state": b64e(s)} for n, s in creates
        ],
        "rid": rid,
    }


def delete_service_name(name: str, rid: int) -> dict:
    return {"type": DELETE_SERVICE_NAME, "name": name, "rid": rid}


def request_active_replicas(name: str, rid: int) -> dict:
    return {"type": REQUEST_ACTIVE_REPLICAS, "name": name, "rid": rid}


def client_reconfigure(name: str, new_actives: List[str], rid: int) -> dict:
    return {
        "type": CLIENT_RECONFIGURE,
        "name": name,
        "new_actives": list(new_actives),
        "rid": rid,
    }


def app_request(
    name: str, payload: bytes, rid: int, need_response: bool = True
) -> dict:
    return {
        "type": APP_REQUEST,
        "name": name,
        "payload": b64e(payload),
        "rid": rid,
        "need_response": need_response,
    }


def app_read(name: str, payload: bytes, rid: int) -> dict:
    return {
        "type": APP_READ,
        "name": name,
        "payload": b64e(payload),
        "rid": rid,
    }


def app_request_batch(reqs, bid: int) -> dict:
    """reqs: list of (name, rid, payload bytes)."""
    return {
        "type": APP_REQUEST_BATCH,
        "bid": bid,
        "reqs": [[n, r, b64e(p)] for n, r, p in reqs],
    }


def stop_epoch(name: str, epoch: int, initiator: str) -> dict:
    return {"type": STOP_EPOCH, "name": name, "epoch": epoch,
            "initiator": initiator}


def start_epoch(
    name: str,
    epoch: int,
    actives: List[str],
    initiator: str,
    prev_epoch: int = -1,
    prev_actives: Optional[List[str]] = None,
    initial_state: Optional[bytes] = None,
) -> dict:
    """prev_epoch < 0 means creation (initial_state seeds the group);
    otherwise the receiving active fetches epoch ``prev_epoch``'s final
    state from ``prev_actives`` (StartEpoch.java's getPrevEpochGroup)."""
    return {
        "type": START_EPOCH,
        "name": name,
        "epoch": epoch,
        "actives": list(actives),
        "initiator": initiator,
        "prev_epoch": prev_epoch,
        "prev_actives": list(prev_actives or []),
        "initial_state": b64e(initial_state),
    }


def drop_epoch(name: str, epoch: int, initiator: str) -> dict:
    return {"type": DROP_EPOCH, "name": name, "epoch": epoch,
            "initiator": initiator}


def demand_report(name: str, epoch: int, stats: dict, reporter: str) -> dict:
    return {"type": DEMAND_REPORT, "name": name, "epoch": epoch,
            "stats": stats, "reporter": reporter}


def request_epoch_final_state(name: str, epoch: int, requester: str) -> dict:
    return {"type": REQUEST_EPOCH_FINAL_STATE, "name": name, "epoch": epoch,
            "requester": requester}


def epoch_final_state(name: str, epoch: int, state: Optional[bytes]) -> dict:
    return {"type": EPOCH_FINAL_STATE, "name": name, "epoch": epoch,
            "state": b64e(state), "found": state is not None}
