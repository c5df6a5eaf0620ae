"""Milliseconds a committed move takes at the move boundary: the
program's `commit` spans (snapshot, re-root, write-back, state table and
the env step) over their count, in the traced window."""

from mcts_bench import spans


def read(ctx):
    n = spans.count(ctx, "commit")
    return 1e3 * spans.seconds(ctx, "commit") / n if n else None
