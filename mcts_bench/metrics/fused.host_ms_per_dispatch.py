"""Host milliseconds a fused dispatch spends preparing and finishing
(ServiceStats t_fused_submit + t_fused_finish over fused_dispatches, in
the traced window)."""


def read(ctx):
    n = ctx.stats["fused_dispatches"]
    if not n:
        return None
    return 1e3 * (ctx.stats["t_fused_submit"] + ctx.stats["t_fused_finish"]) / n
