"""The program's span totals over the window: the counters its tracer
keeps for every complete span (trace_span_seconds_total,
trace_span_self_seconds_total and trace_spans_total, labelled by span
name), as the window's registry delta holds them.  A program that keeps no such totals reads 0."""


def _total(ctx, counter: str, span: str) -> float:
    series = ctx.registry.get(counter, {})
    return float(series.get(f'{counter}{{span="{span}"}}', 0))


def seconds(ctx, *spans: str) -> float:
    """Seconds inside the named spans, summed."""
    return sum(_total(ctx, "trace_span_seconds_total", s) for s in spans)


def self_seconds(ctx, *spans: str) -> float:
    """Seconds inside the named spans and in none of their child spans,
    summed."""
    return sum(_total(ctx, "trace_span_self_seconds_total", s) for s in spans)


def count(ctx, span: str) -> float:
    """Spans of that name ended in the window."""
    return _total(ctx, "trace_spans_total", span)
