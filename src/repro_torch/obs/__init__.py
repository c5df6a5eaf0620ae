"""Observability layer: tracing + metrics for the search service (the
port's copy of repro.obs, pure Python).

  obs.trace    Tracer — nested spans (per-superstep phases: select /
               expand / simulate / backup / compact-gather /
               compact-scatter, fenced with torch.cuda.synchronize only
               when tracing is live) + async request-lifecycle spans,
               recorded into a drop-oldest ring and exported as
               Chrome-trace / Perfetto JSON (``Tracer.export()``).
  obs.metrics  MetricsRegistry — labelled counters / gauges / histograms
               with a Prometheus-exposition-format text snapshot; the
               serving pools and the LM ContinuousBatcher record here.

Entry points: ``SearchClient(trace=True, metrics=True)`` then
``client.trace_export("trace.json")`` / ``client.metrics()``.
"""

from repro_torch.obs.metrics import (
    NULL_METRIC, NULL_REGISTRY, Counter, Gauge, Histogram, MetricsRegistry,
    NullRegistry,
)
from repro_torch.obs.trace import NULL_TRACER, NullTracer, Span, Tracer

__all__ = [
    "Tracer", "NullTracer", "Span", "NULL_TRACER",
    "MetricsRegistry", "NullRegistry", "Counter", "Gauge", "Histogram",
    "NULL_METRIC", "NULL_REGISTRY",
]
