"""HTTP front-ends.

Analogs of ``reconfiguration/http/HttpReconfigurator.java:79`` and
``HttpActiveReplica.java:97`` (tutorial: ``docs/HTTP-API.md``), keeping the
reference's URI dialect:

* reconfigurator edge:  ``GET /?type=CREATE&name=X[&state=S]``,
  ``GET /?type=DELETE&name=X``, ``GET /?type=REQ_ACTIVES&name=X``;
* active-replica edge:  ``GET /?name=X&qval=V`` — a coordinated app request
  whose JSON reply carries ``NAME``/``QVAL``/``RVAL``/``QID``/``COORD``
  (the field names the reference's test app returns).

Where the reference embeds netty servers inside the node processes, here
each edge wraps a :class:`~gigapaxos_tpu_torch.client.ReconfigurableAppClient`
talking the node transport — the HTTP edge is a stateless protocol gateway,
deployable next to any node, and gets the client's retry/redirect behavior
for free.  POST with a JSON body ``{"name":..., "qval":...}`` is accepted
as the equivalent of the query form.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import parse_qs, urlparse

from ..client import ClientError, ReconfigurableAppClient


def _params(handler: BaseHTTPRequestHandler) -> dict:
    q = {k: v[0] for k, v in parse_qs(urlparse(handler.path).query).items()}
    if handler.command == "POST":
        ln = int(handler.headers.get("Content-Length", 0) or 0)
        if ln:
            try:
                q.update(json.loads(handler.rfile.read(ln).decode()))
            except ValueError:
                pass
    return q


def _reply(handler: BaseHTTPRequestHandler, code: int, obj: dict) -> None:
    body = json.dumps(obj).encode()
    handler.send_response(code)
    handler.send_header("Content-Type", "application/json")
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


class _Edge:
    def __init__(self, client: ReconfigurableAppClient,
                 bind: Tuple[str, int]):
        self.client = client
        edge = self

        class Handler(BaseHTTPRequestHandler):
            def _run(self):
                try:
                    edge.handle(self)
                except (BrokenPipeError, ConnectionResetError):
                    pass
                except Exception as e:  # malformed input must still get a reply
                    try:
                        _reply(self, 400, {"FAILED": True, "ERROR": repr(e)})
                    except OSError:
                        pass

            def do_GET(self):  # noqa: N802 (stdlib naming)
                self._run()

            def do_POST(self):  # noqa: N802
                self._run()

            def log_message(self, *a):  # quiet
                pass

        self.server = ThreadingHTTPServer(bind, Handler)
        self.port = self.server.server_address[1]
        self._thread = threading.Thread(
            target=self.server.serve_forever, name=f"http-{self.port}",
            daemon=True,
        )
        self._thread.start()

    def handle(self, h: BaseHTTPRequestHandler) -> None:
        raise NotImplementedError

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()


class HttpReconfigurator(_Edge):
    """Name management over HTTP (HttpReconfigurator.java:79).

    ``placement_table`` (placement/table.py, optional): REQ_ACTIVES answers
    are reordered so a migrated name's new home leads — the HTTP twin of
    the DNS edge's ``placement_policy``."""

    def __init__(self, client: ReconfigurableAppClient,
                 bind: Tuple[str, int], placement_table=None):
        self.placement = placement_table
        super().__init__(client, bind)

    def handle(self, h: BaseHTTPRequestHandler) -> None:
        p = _params(h)
        name = p.get("name")
        rtype = (p.get("type") or "").upper()
        if not name or rtype not in ("CREATE", "DELETE", "REQ_ACTIVES", "234", "235"):
            _reply(h, 400, {"FAILED": True,
                            "ERROR": "need type=CREATE|DELETE|REQ_ACTIVES and name"})
            return
        try:
            if rtype in ("CREATE", "234"):
                r = self.client.create(name, p.get("state", "").encode())
                _reply(h, 200 if r.get("ok") else 409,
                       {"NAME": name, "FAILED": not r.get("ok"),
                        "ACTIVES": r.get("actives"), "ERROR": r.get("error")})
            elif rtype in ("DELETE", "235"):
                r = self.client.delete(name)
                _reply(h, 200 if r.get("ok") else 409,
                       {"NAME": name, "FAILED": not r.get("ok"),
                        "ERROR": r.get("error")})
            else:  # REQ_ACTIVES
                actives = self.client.request_actives(name)
                if self.placement is not None:
                    actives = self.placement.order_actives(name, actives)
                _reply(h, 200, {"NAME": name, "ACTIVES": actives})
        except ClientError as e:
            _reply(h, 404, {"NAME": name, "FAILED": True, "ERROR": str(e)})
        except TimeoutError as e:
            _reply(h, 504, {"NAME": name, "FAILED": True, "ERROR": str(e)})


class HttpActiveReplica(_Edge):
    """Coordinated app requests over HTTP (HttpActiveReplica.java:97):
    ``/?name=X&qval=V`` totally orders V on X and returns the app reply."""

    def handle(self, h: BaseHTTPRequestHandler) -> None:
        p = _params(h)
        name, qval = p.get("name"), p.get("qval")
        if not name or qval is None:
            _reply(h, 400, {"FAILED": True, "ERROR": "need name and qval"})
            return
        # a JSON body may carry non-string values; the wire payload is text
        name, qval = str(name), str(qval)
        try:
            rval = self.client.request(name, qval.encode())
            _reply(h, 200, {
                "NAME": name, "QVAL": qval, "RVAL": rval.decode("utf-8", "replace"),
                "COORD": True, "QID": 0,
            })
        except ClientError as e:
            _reply(h, 404, {"NAME": name, "FAILED": True, "ERROR": str(e)})
        except TimeoutError as e:
            _reply(h, 504, {"NAME": name, "FAILED": True, "ERROR": str(e)})
