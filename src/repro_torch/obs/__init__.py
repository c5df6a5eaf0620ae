"""Observability layer: tracing + metrics for the search service (the
port's copy of repro.obs, pure Python).

  obs.trace    Tracer — nested spans (the per-superstep phases and the
               pool's host work, fenced with torch.cuda.synchronize only
               when tracing is live) + async request-lifecycle spans,
               recorded into a drop-oldest ring and exported as
               Chrome-trace / Perfetto JSON (``Tracer.export()``).  Each
               span name's totals are kept apart from the ring.
  obs.metrics  MetricsRegistry — labelled counters / gauges / histograms
               with a Prometheus-exposition-format text snapshot; the
               serving pools and the LM ContinuousBatcher record here.

The spans of a serving pool, on its own track (obs.trace lists what
each holds):

  superstep / fused-dispatch > admission, select, expand, simulate,
  backup, finalize-build, fused-submit, fused-collect, fused-finish,
  commits > commit > snapshot, reroot, write-back, st-write

and the totals, by span name, that the tracer keeps for every complete
span and publishes through the registry it is bound to:

  trace_span_seconds_total{span=...}       duration
  trace_span_self_seconds_total{span=...}  duration less the child spans
  trace_spans_total{span=...}              spans ended

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
