"""The card's idle share of the profiled slice: 100 less the union of
its device operations' intervals over the slice's wall time."""


def read(ctx):
    if ctx.slice is None:
        return None
    return 100.0 * (1.0 - ctx.slice["busy_s"] / ctx.slice["window_s"])
