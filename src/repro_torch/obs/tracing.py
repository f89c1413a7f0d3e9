"""span()/timed() — nested wall-time tracing that aggregates per name.

A ``span("engine.update")`` times its block and folds the duration into the
owning registry's ``span`` histogram under the span's *path* — nested spans
dot-join (``engine.step.source``), so one histogram series exists per unique
nesting path and :func:`span_totals` reads back an aggregated
``{path: {count, total_s, ...}}`` view without any tree bookkeeping at
runtime. The nesting stack is thread-local, so worker threads trace
independently.

A span records host wall time and never waits for the card: on CUDA the
time of a span around kernel launches is the time to enqueue them, unless
something inside it waits. Spans pass through
``torch.profiler.record_function`` (resolved lazily, once), so the same
names show up in a ``torch.profiler`` capture beside the kernels they
launched, and, where a card is present, through NVTX ranges
(``torch.cuda.nvtx.range_push``/``range_pop``), so an ``nsys`` timeline
shows them without the profiler.

:func:`timed` wraps a callable in a span per call and additionally records
the *first* call under ``<name>.first`` — the first call of a kernel path
builds and loads the CUDA libraries, so that cost is separated from the
steady-state distribution instead of polluting its quantiles.
"""
from __future__ import annotations

import functools
import threading
import time
from contextlib import contextmanager

from repro_torch.obs.registry import MetricsRegistry, default_registry

_tls = threading.local()

SPAN_METRIC = "span"


def _stack() -> list:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


@functools.cache
def _annotators():
    """(``torch.profiler.record_function`` or None, ``torch.cuda.nvtx`` or
    None) — resolved once, lazily, so the obs package imports without
    torch and a CPU-only build gets no NVTX calls."""
    try:
        import torch
    except ImportError:
        return None, None
    nvtx = torch.cuda.nvtx if torch.cuda.is_available() else None
    return torch.profiler.record_function, nvtx


def current_path() -> str | None:
    """The innermost active span path on this thread, if any."""
    s = _stack()
    return s[-1] if s else None


@contextmanager
def span(name: str, registry: MetricsRegistry | None = None,
         annotate: bool = True):
    """Time a block; record seconds into ``registry.histogram("span",
    path=<dotted path>)``. Yields the path."""
    reg = registry if registry is not None else default_registry()
    stack = _stack()
    path = f"{stack[-1]}.{name}" if stack else name
    stack.append(path)
    record, nvtx = _annotators() if annotate else (None, None)
    ann = record(path) if record is not None else None
    if ann is not None:
        ann.__enter__()
    if nvtx is not None:
        nvtx.range_push(path)
    t0 = time.perf_counter()
    try:
        yield path
    finally:
        dt = time.perf_counter() - t0
        if nvtx is not None:
            nvtx.range_pop()
        if ann is not None:
            ann.__exit__(None, None, None)
        stack.pop()
        reg.histogram(SPAN_METRIC, path=path).observe(dt)


def timed(name: str, registry: MetricsRegistry | None = None):
    """Decorator form of :func:`span`; splits the first call (the libraries'
    build and load, on a kernel path) out under ``<name>.first``."""

    def deco(fn):
        first_done = [False]

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            reg = registry if registry is not None else default_registry()
            t0 = time.perf_counter()
            with span(name, reg):
                out = fn(*args, **kwargs)
            if not first_done[0]:
                first_done[0] = True
                reg.histogram(SPAN_METRIC, path=f"{name}.first").observe(
                    time.perf_counter() - t0)
            return out

        return wrapper

    return deco


def span_totals(registry: MetricsRegistry | None = None) -> dict[str, dict]:
    """Aggregated per-path span view: ``{path: {count, total_s, p50, p95,
    p99, max}}`` — the read side of :func:`span`."""
    reg = registry if registry is not None else default_registry()
    out: dict[str, dict] = {}
    for m in reg.metrics():
        if m.name == SPAN_METRIC and m.kind == "histogram":
            s = m.summary()
            out[m.labels.get("path", "")] = {
                "count": s["count"], "total_s": s["sum"], "p50": s["p50"],
                "p95": s["p95"], "p99": s["p99"], "max": s["max"]}
    return out
