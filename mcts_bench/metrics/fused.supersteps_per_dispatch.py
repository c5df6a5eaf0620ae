"""Supersteps a fused K-superstep device dispatch ran before it stopped
(ServiceStats fused_supersteps / fused_dispatches over the traced
window)."""


def read(ctx):
    n = ctx.stats["fused_dispatches"]
    return ctx.stats["fused_supersteps"] / n if n else None
