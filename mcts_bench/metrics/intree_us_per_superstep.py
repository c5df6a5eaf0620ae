"""In-tree microseconds a superstep (the paper's Fig. 4 metric):
ServiceStats t_intree over supersteps in the traced window, whose phase
timers fence the device when the program traces."""


def read(ctx):
    n = ctx.stats["supersteps"]
    return 1e6 * ctx.stats["t_intree"] / n if n else None
