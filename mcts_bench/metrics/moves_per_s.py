"""Moves committed inside the window over the window's length."""


def read(ctx):
    return len(ctx.loop.committed()) / ctx.window_s
