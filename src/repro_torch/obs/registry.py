"""MetricsRegistry — the repo's one metrics vocabulary: counters, gauges,
histograms.

Dependency-free (stdlib + numpy), thread-safe, and zero-cost when disabled: a
``MetricsRegistry(enabled=False)`` hands every caller the same shared no-op
metric objects, so instrumented hot paths pay one attribute call on a
do-nothing method and nothing else — no allocation, no locking, no retention.

Metric identity is ``(name, labels)``: ``registry.counter("serve.folds",
group="g0")`` and ``group="g1"`` are independent series, the way a Prometheus
label set works. Lookups cache the metric object, so call sites that keep a
reference (the engine's per-step loop, the serving worker) pay only the
increment; call sites that re-look-up per event pay one dict get under the
registry lock.

Histograms keep exact ``count``/``sum``/``min``/``max`` plus a bounded
ring-buffer reservoir of the most recent observations for quantile estimation
(:meth:`Histogram.quantile`, p50/p95/p99 in :meth:`Histogram.summary`). The
reservoir bounds memory on unbounded streams; totals stay exact forever.

:func:`quantiles` is THE repo-wide quantile helper — the launchers and
benchmarks compute their latency percentiles through it rather than keeping
per-file copies.
"""
from __future__ import annotations

import threading
from typing import Iterable

import numpy as np

DEFAULT_QUANTILES = (0.5, 0.95, 0.99)


def quantiles(values: Iterable[float],
              qs: tuple[float, ...] = DEFAULT_QUANTILES) -> tuple[float, ...]:
    """Empirical quantiles of a sequence, as plain floats (NaN when empty).

    The one shared implementation behind ``Histogram.summary``, the
    launchers' latency p50/p99 lines, and the benchmark gates.
    """
    arr = np.asarray(tuple(values), dtype=np.float64)
    if arr.size == 0:
        return tuple(float("nan") for _ in qs)
    return tuple(float(v) for v in np.quantile(arr, qs))


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


class Counter:
    """Monotonic counter. ``inc`` is atomic (per-metric lock), so concurrent
    writers sum exactly — tests hammer this from 8 threads."""

    kind = "counter"
    __slots__ = ("name", "labels", "_lock", "_value")

    def __init__(self, name: str, labels: dict):
        self.name, self.labels = name, dict(labels)
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int | float = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value

    def read(self) -> dict:
        return {"type": self.kind, "value": self.value}


class Gauge:
    """Last-write-wins instantaneous value (queue depth, rows/sec, bytes)."""

    kind = "gauge"
    __slots__ = ("name", "labels", "_lock", "_value")

    def __init__(self, name: str, labels: dict):
        self.name, self.labels = name, dict(labels)
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def read(self) -> dict:
        return {"type": self.kind, "value": self.value}


class Histogram:
    """Exact count/sum/min/max + a bounded reservoir of the most recent
    ``window`` observations for quantiles. ``observe`` is atomic."""

    kind = "histogram"
    __slots__ = ("name", "labels", "window", "_lock", "_count", "_sum",
                 "_min", "_max", "_buf", "_pos")

    def __init__(self, name: str, labels: dict, window: int = 4096):
        self.name, self.labels = name, dict(labels)
        self.window = int(window)
        self._lock = threading.Lock()
        self._count = 0
        self._sum = 0.0
        self._min = self._max = None
        self._buf: list[float] = []
        self._pos = 0   # ring-buffer write head once the window is full

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._count += 1
            self._sum += v
            self._min = v if self._min is None else min(self._min, v)
            self._max = v if self._max is None else max(self._max, v)
            if len(self._buf) < self.window:
                self._buf.append(v)
            else:
                self._buf[self._pos] = v
                self._pos = (self._pos + 1) % self.window

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def quantile(self, *qs: float) -> tuple[float, ...]:
        with self._lock:
            buf = tuple(self._buf)
        return quantiles(buf, qs or DEFAULT_QUANTILES)

    def summary(self) -> dict:
        with self._lock:
            buf, count, total = tuple(self._buf), self._count, self._sum
            lo, hi = self._min, self._max
        p50, p95, p99 = quantiles(buf, DEFAULT_QUANTILES)
        return {"count": count, "sum": total, "min": lo, "max": hi,
                "p50": p50, "p95": p95, "p99": p99}

    def read(self) -> dict:
        return {"type": self.kind, **self.summary()}


class _NullMetric:
    """Shared do-nothing stand-in handed out by a disabled registry."""

    kind = "null"
    name, labels = "", {}

    def inc(self, n=1):
        pass

    def set(self, v):
        pass

    def observe(self, v):
        pass

    value = 0
    count = 0
    sum = 0.0

    def quantile(self, *qs):
        return tuple(float("nan") for _ in (qs or DEFAULT_QUANTILES))

    def summary(self):
        return {}

    def read(self):
        return {}


_NULL = _NullMetric()


class MetricsRegistry:
    """Thread-safe home for a process's metrics.

    ``enabled=False`` makes every accessor return the shared no-op metric —
    the zero-cost-when-disabled contract instrumented code relies on instead
    of guarding each call site.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._metrics: dict[tuple, Counter | Gauge | Histogram] = {}

    # ------------------------------------------------------------ accessors --

    def _get(self, cls, name: str, labels: dict, **kw):
        if not self.enabled:
            return _NULL
        key = (cls.kind, name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = cls(name, labels, **kw)
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, window: int = 4096, **labels) -> Histogram:
        return self._get(Histogram, name, labels, window=window)

    # ------------------------------------------------------------- reading --

    def metrics(self) -> list:
        """The live metric objects (stable snapshot of the collection)."""
        with self._lock:
            return list(self._metrics.values())

    def snapshot(self) -> dict[str, dict]:
        """In-process snapshot API: ``{name{labels}: reading}`` for every
        metric. Per-metric readings are atomic; the collection is the set of
        metrics registered at call time."""
        out = {}
        for m in self.metrics():
            lbl = ",".join(f"{k}={v}" for k, v in sorted(m.labels.items()))
            out[f"{m.name}{{{lbl}}}" if lbl else m.name] = m.read()
        return out

    def reset(self) -> None:
        """Drop every metric (tests and benchmark arms start clean)."""
        with self._lock:
            self._metrics.clear()


#: registry handed to call sites that don't thread one through explicitly
#: (kernel dispatch counters, bare span() calls).
_default = MetricsRegistry()
#: always-disabled registry for explicit "no telemetry" wiring.
NULL_REGISTRY = MetricsRegistry(enabled=False)


def default_registry() -> MetricsRegistry:
    return _default


def set_default_registry(reg: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-wide default registry; returns the previous one."""
    global _default
    prev, _default = _default, reg
    return prev
