"""Share of the traced window a pool's tick spends in no finer span: the
own time of the program's `superstep` and `fused-dispatch` spans (their
duration less their child spans') over the window's length, in percent.
It is the tick's host work that no narrower span names, and so what an
idle gap charged to the tick itself can hide."""

from mcts_bench import spans

TICKS = ("superstep", "fused-dispatch")


def read(ctx):
    if not any(spans.count(ctx, s) for s in TICKS):
        return None
    return 100.0 * spans.self_seconds(ctx, *TICKS) / ctx.window_s
