"""Observability (the port's copy of repro.obs.metrics; the tracer waits
for the serving slice that records spans, ROADMAP.md queue A item 4)."""

from repro_torch.obs.metrics import NULL_REGISTRY, MetricsRegistry

__all__ = ["MetricsRegistry", "NULL_REGISTRY"]
