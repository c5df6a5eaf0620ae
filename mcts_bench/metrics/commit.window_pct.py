"""Share of the traced window spent at the move boundary: the program's
`commits` spans (every dispatched slot's boundary check and its
committed moves) over the window's length, in percent."""

from mcts_bench import spans


def read(ctx):
    if not spans.count(ctx, "commits"):
        return None
    return 100.0 * spans.seconds(ctx, "commits") / ctx.window_s
