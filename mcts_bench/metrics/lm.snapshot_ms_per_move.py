"""Milliseconds of root snapshot work a committed move: the program's
`lm-snapshot` spans (prompt prefills at admission and one-token advances
at commits) over the moves committed in the window."""

from mcts_bench import spans


def read(ctx):
    n = len(ctx.loop.committed())
    if not n or not spans.count(ctx, "lm-snapshot"):
        return None
    return 1e3 * spans.seconds(ctx, "lm-snapshot") / n
