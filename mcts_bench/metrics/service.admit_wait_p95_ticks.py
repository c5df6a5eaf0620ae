"""The 95th percentile of the ticks a search waited in the admission
queue, from the program's ServiceStats.wait_supersteps histogram over the
traced window (searches admitted in it)."""


def read(ctx):
    hist = ctx.stats["wait_supersteps"]
    total = sum(hist.values())
    if not total:
        return None
    seen = 0
    for wait in sorted(hist):
        seen += hist[wait]
        if seen >= 0.95 * total:
            return float(wait)
