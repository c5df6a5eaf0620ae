"""MetricsRegistry — counters / gauges / histograms, Prometheus text out.

The port's copy of repro.obs.metrics (pure Python, unchanged): the LM
serving slice's ContinuousBatcher records its ``serving_*`` metrics here.

The numeric half of the observability layer (obs.trace is the temporal
half): every serving layer registers its telemetry here — queue depth
and smoothed load per bucket, fused-batch sizes, admission waits,
eviction / retirement / expiry counts, expansion batch calls, compaction
decisions — and ``render()`` emits one snapshot in Prometheus exposition
format (the text format every scrape pipeline ingests):

    # HELP service_queue_depth requests queued, not yet admitted
    # TYPE service_queue_depth gauge
    service_queue_depth{bucket="X512_D8_Fp8"} 3

Zero dependencies, get-or-create semantics: two layers asking for the
same (name, labels) share the one time series, so the scheduler core and
its pools can instrument independently without coordination.  Metric
objects are plain attribute bumps (`inc`/`set`/`observe`) — cheap enough
for per-superstep call sites.

NULL_REGISTRY is the disabled path: the same surface returning shared
no-op metric objects, `enabled` False, `render()` empty.  Layers default
to it; the `service_obs_overhead` BENCH row pins the resulting
disabled-path cost at well under the 2% CI gate.
"""

from __future__ import annotations

from bisect import bisect_left

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "NullRegistry",
    "NULL_METRIC", "NULL_REGISTRY",
]

# powers-of-two style buckets suit the layer's unit mix (ticks, rows)
DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


class Counter:
    """Monotonically increasing count."""

    kind = "counter"
    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: dict):
        self.name, self.labels = name, labels
        self.value = 0

    def inc(self, n=1):
        self.value += n

    def rows(self):
        yield "", self.value


class Gauge:
    """A value that goes up and down."""

    kind = "gauge"
    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: dict):
        self.name, self.labels = name, labels
        self.value = 0

    def set(self, v):
        self.value = v

    def inc(self, n=1):
        self.value += n

    def dec(self, n=1):
        self.value -= n

    def rows(self):
        yield "", self.value


class Histogram:
    """Cumulative-bucket histogram (Prometheus `le` convention: each
    exported bucket counts observations <= its upper bound, closed by
    the implicit +Inf bucket; `_sum` and `_count` ride along)."""

    kind = "histogram"
    __slots__ = ("name", "labels", "bounds", "counts", "sum", "count")

    def __init__(self, name: str, labels: dict, buckets=DEFAULT_BUCKETS):
        self.name, self.labels = name, labels
        self.bounds = tuple(sorted(buckets))
        self.counts = [0] * (len(self.bounds) + 1)   # +1: the +Inf bucket
        self.sum = 0
        self.count = 0

    def observe(self, v):
        self.counts[bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    def rows(self):
        cum = 0
        for bound, n in zip(self.bounds, self.counts):
            cum += n
            yield f'_bucket:le="{_fmt(bound)}"', cum
        yield '_bucket:le="+Inf"', self.count
        yield "_sum", self.sum
        yield "_count", self.count


def _fmt(v) -> str:
    if isinstance(v, float):
        if v == float("inf"):
            return "+Inf"
        return f"{v:g}"
    return str(v)


def _escape(v) -> str:
    return str(v).replace("\\", r"\\").replace('"', r"\"").replace(
        "\n", r"\n")


def _label_str(labels: dict, extra: str = "") -> str:
    parts = [f'{k}="{_escape(v)}"' for k, v in sorted(labels.items())]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Get-or-create registry of labelled metrics + Prometheus render."""

    enabled = True

    def __init__(self):
        # name -> {sorted-label-items -> metric}; insertion order kept so
        # snapshots are stable run to run
        self._metrics: dict[str, dict] = {}
        self._kinds: dict[str, str] = {}
        self._helps: dict[str, str] = {}

    # ---- registration (get-or-create) ----
    def _get(self, kind: str, name: str, help: str, labels: dict, **kw):
        known = self._kinds.get(name)
        if known is None:
            self._kinds[name] = kind
            self._helps[name] = help
            self._metrics[name] = {}
        elif known != kind:
            raise ValueError(
                f"metric {name!r} already registered as {known}, "
                f"requested {kind}")
        elif help and not self._helps[name]:
            self._helps[name] = help
        series = self._metrics[name]
        key = tuple(sorted(labels.items()))
        metric = series.get(key)
        if metric is None:
            metric = series[key] = _KINDS[kind](name, labels, **kw)
        return metric

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get("counter", name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get("gauge", name, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets=DEFAULT_BUCKETS, **labels) -> Histogram:
        return self._get("histogram", name, help, labels, buckets=buckets)

    # ---- read-out ----
    def get(self, name: str, **labels):
        """The metric at (name, labels), or None (tests / dashboards)."""
        return self._metrics.get(name, {}).get(tuple(sorted(labels.items())))

    def snapshot(self) -> dict:
        """{name: {label_str: value}} for counters/gauges, histogram
        series expanded — a dict mirror of render() for programmatic
        consumers."""
        out: dict = {}
        for name in self._metrics:
            series = out.setdefault(name, {})
            for metric in self._metrics[name].values():
                for suffix, value in metric.rows():
                    extra = ""
                    if ":" in suffix:
                        suffix, extra = suffix.split(":", 1)
                    series[f"{name}{suffix}"
                           f"{_label_str(metric.labels, extra)}"] = value
        return out

    def render(self) -> str:
        """One Prometheus-exposition-format snapshot of every series."""
        lines = []
        for name in self._metrics:
            if self._helps[name]:
                lines.append(f"# HELP {name} {self._helps[name]}")
            lines.append(f"# TYPE {name} {self._kinds[name]}")
            for metric in self._metrics[name].values():
                for suffix, value in metric.rows():
                    extra = ""
                    if ":" in suffix:
                        suffix, extra = suffix.split(":", 1)
                    lines.append(
                        f"{name}{suffix}"
                        f"{_label_str(metric.labels, extra)} {_fmt(value)}")
        return "\n".join(lines) + ("\n" if lines else "")


class _NullMetric:
    """Shared no-op metric: every mutator a pass."""

    __slots__ = ()

    def inc(self, n=1):
        pass

    def dec(self, n=1):
        pass

    def set(self, v):
        pass

    def observe(self, v):
        pass


NULL_METRIC = _NullMetric()


class NullRegistry:
    """The disabled path: same surface, no-op metrics, empty render."""

    enabled = False

    def counter(self, name, help="", **labels):
        return NULL_METRIC

    def gauge(self, name, help="", **labels):
        return NULL_METRIC

    def histogram(self, name, help="", buckets=DEFAULT_BUCKETS, **labels):
        return NULL_METRIC

    def get(self, name, **labels):
        return None

    def snapshot(self) -> dict:
        return {}

    def render(self) -> str:
        return ""


NULL_REGISTRY = NullRegistry()
