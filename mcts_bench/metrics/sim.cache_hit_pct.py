"""The share of simulation rows the transposition cache answered
(sim_cache_hits_total over hits and misses in the traced window)."""


def read(ctx):
    hits = ctx.counter("sim_cache_hits_total")
    total = hits + ctx.counter("sim_cache_misses_total")
    return 100.0 * hits / total if total else None
