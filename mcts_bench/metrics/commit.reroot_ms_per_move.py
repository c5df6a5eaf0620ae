"""Milliseconds a committed move spends re-rooting on the host: the
`reroot` and `st-write` (state table compacted or flushed) spans over
the count of `commit` spans, in the traced window."""

from mcts_bench import spans


def read(ctx):
    n = spans.count(ctx, "commit")
    return 1e3 * spans.seconds(ctx, "reroot", "st-write") / n \
        if n else None
