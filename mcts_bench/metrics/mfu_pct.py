"""The net's share of the card's float32 peak over the traced window:
the FLOPs of the rows the net evaluated (the SimServer's real rows,
costs/net.py) over the window's length and 67 TFLOP/s (float32 without
tensor cores: the net runs with TF32 off)."""

from mcts_bench.costs import net, peaks


def read(ctx):
    rows = ctx.counter("sim_server_rows_total")
    if not rows:
        return None
    flops = rows * net.flops_per_row(ctx.config["net"]["channels"])
    return 100.0 * flops / ctx.window_s / peaks.F32_FLOPS
