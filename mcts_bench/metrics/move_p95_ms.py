"""The 95th percentile of the latency of every move asked in the window,
drained ones included: from the client's ask (its submit, or the
previous move's commit) to the commit as the client sees it."""

import numpy as np


def read(ctx):
    lat = [ctx.loop.latency_s(s, i) for s, i in ctx.loop.asked()]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
