"""Real rows in each forward the SimServer dispatched (its rows and
batches counters over the traced window; a forward is padded to
max_batch)."""


def read(ctx):
    batches = ctx.counter("sim_server_batches_total")
    return ctx.counter("sim_server_rows_total") / batches if batches else None
