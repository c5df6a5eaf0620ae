"""Milliseconds the host waits for a fused dispatch's one read-back: the
program's `fused-collect` spans over their count, in the traced
window."""

from mcts_bench import spans


def read(ctx):
    n = spans.count(ctx, "fused-collect")
    return 1e3 * spans.seconds(ctx, "fused-collect") / n if n else None
