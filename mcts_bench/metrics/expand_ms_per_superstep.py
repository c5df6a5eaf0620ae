"""Host expansion milliseconds a superstep (ServiceStats t_expand over
supersteps in the traced window)."""


def read(ctx):
    n = ctx.stats["supersteps"]
    return 1e3 * ctx.stats["t_expand"] / n if n else None
