"""Set-up: process start to window start (imports, the kernels' load or
build, the weights, the client, every graph capture and the warm-up
ticks)."""


def read(ctx):
    return ctx.setup_s
