"""The scrape endpoint: a tiny threaded HTTP server (stdlib only).

Routes (every route served here MUST be listed in this docstring —
tests/test_torch_obs.py enforces it):

* ``GET /metrics``       -> Prometheus text (the ``scrape`` callback)
* ``GET /trace/<tid>``   -> JSON timeline for one trace id (``trace`` cb)
* ``GET /trace``         -> JSON list of recent trace ids
* ``GET /flight``        -> JSON flight-recorder ring (``flight`` cb)
* ``GET /healthz``       -> readiness probe: 200 while ticking, 503 when
  the WAL is stickily failed or the node is draining (``healthz`` cb)
* ``GET /health``        -> JSON group-health summary: gauges, log2
  histograms, top-K stuck/churny/hot groups (``health`` cb)
* ``GET /group/<name>``  -> JSON single-group drill-down (``group`` cb;
  404 when the group is not resident)
* ``GET /timeline``      -> JSON scenario timeline: metric series vs wall
  clock with event annotations (``timeline`` cb)

Every route also answers ``HEAD`` (same status/headers, no body).

Bound to ``127.0.0.1`` by default — operators front it with their own
ingress; port 0 picks an ephemeral port (tests), ``.port`` reports it.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional


class MetricsServer:
    def __init__(self, scrape: Callable[[], str],
                 trace: Optional[Callable[[Optional[str]], object]] = None,
                 flight: Optional[Callable[[], object]] = None,
                 healthz: Optional[Callable[[], dict]] = None,
                 health: Optional[Callable[[], object]] = None,
                 group: Optional[Callable[[str], object]] = None,
                 timeline: Optional[Callable[[], object]] = None,
                 port: int = 0, host: str = "127.0.0.1"):
        self._scrape = scrape
        self._trace = trace
        self._flight = flight
        self._healthz = healthz
        self._health = health
        self._group = group
        self._timeline = timeline
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # no stderr chatter
                pass

            def _send(self, code: int, body: str, ctype: str) -> None:
                data = body.encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                if self.command != "HEAD":
                    self.wfile.write(data)

            def _json(self, obj, code: int = 200) -> None:
                self._send(code, json.dumps(obj), "application/json")

            def do_GET(self):
                try:
                    path = self.path.split("?", 1)[0].rstrip("/") or "/"
                    if path == "/metrics":
                        self._send(200, outer._scrape(),
                                   "text/plain; version=0.0.4")
                    elif path == "/trace" and outer._trace is not None:
                        self._json(outer._trace(None))
                    elif (path.startswith("/trace/")
                          and outer._trace is not None):
                        tid = path[len("/trace/"):]
                        self._json(outer._trace(tid))
                    elif path == "/flight" and outer._flight is not None:
                        self._json(outer._flight())
                    elif path == "/healthz" and outer._healthz is not None:
                        # readiness contract: 200 iff the node can make
                        # progress — a stickily failed WAL or a draining
                        # node answers 503 so balancers/supervisors stop
                        # routing to it while it still serves diagnostics
                        doc = outer._healthz()
                        self._json(doc, 200 if doc.get("ok") else 503)
                    elif path == "/health" and outer._health is not None:
                        doc = outer._health()
                        if doc is None:
                            self._json({"error": "health fold off"}, 404)
                        else:
                            self._json(doc)
                    elif (path.startswith("/group/")
                          and outer._group is not None):
                        name = path[len("/group/"):]
                        doc = outer._group(name)
                        if doc is None:
                            self._json({"error": "no such group"}, 404)
                        else:
                            self._json(doc)
                    elif path == "/timeline" and outer._timeline is not None:
                        self._json(outer._timeline())
                    else:
                        self._send(404, "not found\n", "text/plain")
                except BrokenPipeError:
                    pass
                except Exception as e:  # a broken source must not kill serve
                    try:
                        self._send(500, f"{type(e).__name__}: {e}\n",
                                   "text/plain")
                    except Exception:
                        pass

            # HEAD mirrors GET byte-for-byte in status and headers; _send
            # suppresses the body when self.command == "HEAD"
            do_HEAD = do_GET

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.2},
            name=f"metrics-http:{self.port}", daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:
            pass
        self._thread.join(timeout=2)
