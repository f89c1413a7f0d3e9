"""Metric sinks: Prometheus-style text exposition + a scrape endpoint.

:func:`render_exposition` serializes a registry in the Prometheus text
format — counters and gauges as single samples, histograms as summaries
(``_count`` / ``_sum`` plus ``quantile=`` samples from the reservoir). Metric
names sanitize ``.``/``-`` to ``_``; label values escape per the format spec.
The output is deterministic (sorted by name, then label set) so tests can pin
it as a snapshot.

:class:`MetricsServer` is the stdlib scrape endpoint (daemon-threaded
``ThreadingHTTPServer``): ``GET /metrics`` answers the exposition text,
``GET /metrics.json`` the :meth:`MetricsRegistry.snapshot` JSON. The launchers
hang one off ``--metrics-port`` so a long-lived run can be watched
with nothing but curl.
"""
from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from repro_torch.obs.registry import DEFAULT_QUANTILES, MetricsRegistry

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    return _NAME_RE.sub("_", name)


def _prom_labels(labels: dict, extra: dict | None = None) -> str:
    merged = {**labels, **(extra or {})}
    if not merged:
        return ""
    body = ",".join(
        '{}="{}"'.format(_prom_name(str(k)),
                         str(v).replace("\\", r"\\").replace('"', r"\"")
                               .replace("\n", r"\n"))
        for k, v in sorted(merged.items()))
    return "{" + body + "}"


def _fmt(v) -> str:
    if v is None or v != v:  # None / NaN
        return "NaN"
    f = float(v)
    # ±Inf per the Prometheus text format; int(inf) would raise OverflowError
    # below, so one infinite gauge (or histogram sum) must not kill a scrape
    if f == float("inf"):
        return "+Inf"
    if f == float("-inf"):
        return "-Inf"
    return str(int(f)) if f == int(f) else repr(f)


def render_exposition(registry: MetricsRegistry) -> str:
    """The registry as Prometheus text-format exposition (sorted, stable)."""
    lines: list[str] = []
    typed: set[str] = set()
    for m in sorted(registry.metrics(),
                    key=lambda m: (m.name, sorted(m.labels.items()))):
        name = _prom_name(m.name)
        if m.kind == "counter":
            if name not in typed:
                typed.add(name)
                lines.append(f"# TYPE {name} counter")
            lines.append(f"{name}{_prom_labels(m.labels)} {_fmt(m.value)}")
        elif m.kind == "gauge":
            if name not in typed:
                typed.add(name)
                lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name}{_prom_labels(m.labels)} {_fmt(m.value)}")
        elif m.kind == "histogram":
            if name not in typed:
                typed.add(name)
                lines.append(f"# TYPE {name} summary")
            s = m.summary()
            for q, key in zip(DEFAULT_QUANTILES, ("p50", "p95", "p99")):
                lines.append(f"{name}{_prom_labels(m.labels, {'quantile': q})}"
                             f" {_fmt(s[key])}")
            lines.append(f"{name}_count{_prom_labels(m.labels)} "
                         f"{_fmt(s['count'])}")
            lines.append(f"{name}_sum{_prom_labels(m.labels)} "
                         f"{_fmt(s['sum'])}")
    return "\n".join(lines) + ("\n" if lines else "")


class _Handler(BaseHTTPRequestHandler):
    registry: MetricsRegistry  # class attr, bound per-server subclass

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        if self.path.split("?")[0] == "/metrics":
            body = render_exposition(self.registry).encode()
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        elif self.path.split("?")[0] == "/metrics.json":
            body = json.dumps(self.registry.snapshot(), default=str).encode()
            ctype = "application/json"
        else:
            self.send_error(404, "try /metrics or /metrics.json")
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # scrapes must not spam the run's stdout
        pass


class MetricsServer:
    """A daemon-threaded scrape endpoint over one registry. ``port=0`` binds
    an ephemeral port (read it back off ``.port``/``.url``)."""

    def __init__(self, registry: MetricsRegistry, port: int = 0,
                 host: str = "127.0.0.1"):
        handler = type("_BoundHandler", (_Handler,), {"registry": registry})
        self._httpd = ThreadingHTTPServer((host, int(port)), handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self.url = f"http://{host}:{self.port}/metrics"
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="obs-metrics")
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join()

    def __enter__(self) -> "MetricsServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def serve_metrics(registry: MetricsRegistry, port: int = 0) -> MetricsServer:
    """Start a /metrics endpoint for ``registry``; returns the live server."""
    return MetricsServer(registry, port)
