"""HTTP frontend for a :class:`~repro_torch.sketchserve.service.SketchService`.

The stdlib wire layer that makes the service reachable from outside the
process — same daemon-threaded ``ThreadingHTTPServer`` shape as the
``/metrics`` endpoint in :mod:`repro_torch.obs.sinks`, mapped straight onto
``submit()``:

- ``POST /ingest``  body ``{"target": gid, "rows": [[...], ...]}``
- ``GET  /query?tenant=t&op=components`` (ops with an ``x`` payload —
  transform/predict — POST ``{"tenant", "op", "x"}`` instead)
- ``POST /admin``   body ``{"op": "create_tenant", "params": {...}}`` —
  a ``plan`` param travels as the :func:`~repro_torch.sketchserve.snapshot
  .plan_from_json` dict encoding
- ``GET  /healthz`` liveness (also reports worker/tenant counts)

Response bodies are :func:`~repro_torch.sketchserve.protocol.response_to_json`;
the HTTP status code IS the Response status
(:data:`~repro_torch.sketchserve.protocol.HTTP_STATUS`): ok → 200, **rejected →
429** with a ``Retry-After`` header — admission-control backpressure
crossing the wire intact, so a remote producer backs off exactly like an
in-process one — and error → 400. Malformed JSON is 400 before it reaches
the queue; unknown paths are 404.

Each HTTP request blocks its (daemon) handler thread on the submitted
Future, so slow folds hold sockets, not the service: the worker pool keeps
micro-batching underneath, and concurrent HTTP producers coalesce exactly
like in-process ones. The port of ``repro.sketchserve.http``, with the same
routes, bodies and codes; rows arrive as JSON lists (numpy on the host) and
fold on the service's device.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from repro_torch.sketchserve.protocol import (HTTP_STATUS, AdminRequest,
                                        IngestRequest, QueryRequest, Response,
                                        response_to_json)

#: advisory client back-off after a 429 (seconds) — the backlog is a fold or
#: two away from draining, not minutes.
RETRY_AFTER_S = 1


class _Handler(BaseHTTPRequestHandler):
    service = None          # class attrs, bound per-server subclass
    timeout_s: float = 60.0

    # ---------------------------------------------------------------- plumbing

    def _send(self, code: int, body: dict, retry_after: bool = False) -> None:
        data = json.dumps(body).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        if retry_after:
            self.send_header("Retry-After", str(RETRY_AFTER_S))
        self.end_headers()
        self.wfile.write(data)

    def _send_response(self, resp: Response) -> None:
        self._send(HTTP_STATUS.get(resp.status, 500), response_to_json(resp),
                   retry_after=resp.status == "rejected")

    def _json_body(self) -> dict | None:
        try:
            n = int(self.headers.get("Content-Length") or 0)
            body = json.loads(self.rfile.read(n) or b"{}")
            if not isinstance(body, dict):
                raise ValueError("body must be a JSON object")
            return body
        except Exception as e:  # noqa: BLE001 — malformed input is a 400
            self._send(400, {"status": "error", "result": None,
                             "error": f"bad JSON body: {e}", "info": {}})
            return None

    def _serve(self, req) -> None:
        resp = self.service.submit(req).result(self.timeout_s)
        self._send_response(resp)

    def log_message(self, *args):  # requests must not spam the run's stdout
        pass

    # ---------------------------------------------------------------- routes

    def do_POST(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        path = self.path.split("?")[0]
        body = self._json_body()
        if body is None:
            return
        try:
            if path == "/ingest":
                rows = np.asarray(body["rows"], dtype=np.float64)
                self._serve(IngestRequest(str(body["target"]), rows))
            elif path == "/query":
                x = body.get("x")
                self._serve(QueryRequest(
                    str(body["tenant"]), str(body["op"]),
                    None if x is None else np.asarray(x, dtype=np.float64)))
            elif path == "/admin":
                self._serve(_admin_from_json(body))
            else:
                self._send(404, {"status": "error", "result": None,
                                 "error": f"unknown path {path!r} "
                                          "(/ingest /query /admin /healthz)",
                                 "info": {}})
        except (KeyError, TypeError, ValueError) as e:
            self._send(400, {"status": "error", "result": None,
                             "error": f"bad request: {e!r}", "info": {}})

    def do_GET(self):  # noqa: N802
        u = urlparse(self.path)
        if u.path == "/healthz":
            svc = self.service
            self._send(200, {"status": "ok",
                             "result": {"workers": svc.n_workers,
                                        "tenants": len(svc.tenants()),
                                        "evicted": len(svc.evicted())},
                             "error": None, "info": {}})
            return
        if u.path != "/query":
            self._send(404, {"status": "error", "result": None,
                             "error": f"unknown path {u.path!r} "
                                      "(GET /query or /healthz)", "info": {}})
            return
        q = parse_qs(u.query)
        try:
            tenant, = q["tenant"]
            op, = q["op"]
        except (KeyError, ValueError):
            self._send(400, {"status": "error", "result": None,
                             "error": "GET /query needs tenant= and op=",
                             "info": {}})
            return
        self._serve(QueryRequest(tenant, op))


def _admin_from_json(body: dict) -> AdminRequest:
    """Wire admin op → AdminRequest; a create_tenant plan dict decodes
    through the snapshot Plan codec (mesh geometry + dtype strings)."""
    op = str(body["op"])
    params = dict(body.get("params") or {})
    if op == "create_tenant":
        from repro_torch.sketchserve.snapshot import plan_from_json
        if params.get("plan") is not None:
            params["plan"] = plan_from_json(params["plan"])
        params = dict(tid=str(params.pop("tid")),
                      kind=str(params.pop("kind")),
                      plan=params.pop("plan", None),
                      key=params.pop("key", 0),
                      group=params.pop("group", None),
                      retain_ingest=bool(params.pop("retain_ingest", False)),
                      params=dict(params.pop("params", {})))
    return AdminRequest(op, params)


class HttpFrontend:
    """A daemon-threaded HTTP endpoint over one service. ``port=0`` binds an
    ephemeral port (read it back off ``.port``/``.url``); does not own the
    service's lifecycle — start/stop it separately."""

    def __init__(self, service, port: int = 0, host: str = "127.0.0.1",
                 timeout_s: float = 60.0):
        handler = type("_BoundHandler", (_Handler,),
                       {"service": service, "timeout_s": float(timeout_s)})
        self._httpd = ThreadingHTTPServer((host, int(port)), handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self.url = f"http://{host}:{self.port}"
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="sketchserve-http")
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join()

    def __enter__(self) -> "HttpFrontend":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def serve_http(service, port: int = 0, host: str = "127.0.0.1",
               timeout_s: float = 60.0) -> HttpFrontend:
    """Expose ``service`` over HTTP; returns the live frontend."""
    return HttpFrontend(service, port, host, timeout_s)
