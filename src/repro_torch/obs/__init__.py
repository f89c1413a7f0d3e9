"""repro_torch.obs — telemetry: metrics, tracing, structured step logs.

The reference's ``repro.obs`` with the same public names. The registry, the
step log and the sinks are carried-over copies (stdlib and numpy; the
exposition text is byte-equal to the reference's for the same registry
operations); the tracing passes through ``torch.profiler.record_function``
and, on a card, NVTX ranges, where the reference passes through
``jax.profiler.TraceAnnotation``. The pieces:

- :class:`MetricsRegistry` — thread-safe counters / gauges / histograms
  (p50/p95/p99 from a bounded reservoir), label-keyed series, an in-process
  ``snapshot()`` API, and a shared no-op mode so disabled telemetry is free.
- :func:`span` / :func:`timed` — nesting host wall-time tracing aggregated per
  dotted path.
- :class:`StepLogger` / :func:`read_jsonl` — structured JSONL step records.
- :func:`render_exposition` / :class:`MetricsServer` — Prometheus-style text
  exposition and a stdlib scrape endpoint.
- :func:`quantiles` — the shared percentile helper.

Wired consumers: ``StreamEngine.run(telemetry=)`` (per-step engine metrics),
``repro_torch.sketchserve.SketchService`` (its ``stats`` dict is a registry
snapshot), and the ``repro_torch.kernels.ops`` dispatch counters
(``kernels.dispatch{op=,path=}``, counted per call — watch the
``path="ref"`` series for plain versions running where a kernel should).
"""
from repro_torch.obs.registry import (  # noqa: F401
    DEFAULT_QUANTILES,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NULL_REGISTRY,
    default_registry,
    quantiles,
    set_default_registry,
)
from repro_torch.obs.sinks import (  # noqa: F401
    MetricsServer,
    render_exposition,
    serve_metrics,
)
from repro_torch.obs.steplog import StepLogger, read_jsonl  # noqa: F401
from repro_torch.obs.tracing import (  # noqa: F401
    current_path,
    span,
    span_totals,
    timed,
)
