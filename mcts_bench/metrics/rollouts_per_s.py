"""Simulations backed up over the window's length, counted from the
answers: for each move committed in the window, the visits its root's
edges hold at the commit less those the re-root carried in (the chosen
child's visits at the previous commit).  A backup that ended at the root
itself (a leaf there) reaches no edge and is not counted."""


def read(ctx):
    reuse = ctx.config["server"].get("reuse_subtree", True)
    n = 0
    for s, i in ctx.loop.committed():
        n += int(s.moves[i][1].sum())
        if i and reuse:
            action, visits = s.moves[i - 1]
            n -= int(visits[action])
    return n / ctx.window_s
