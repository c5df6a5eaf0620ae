"""Milliseconds a committed move spends copying its slot's tree: the
device-to-host `snapshot` and the host-to-device `write-back` spans over
the count of `commit` spans, in the traced window."""

from mcts_bench import spans


def read(ctx):
    n = spans.count(ctx, "commit")
    return 1e3 * spans.seconds(ctx, "snapshot", "write-back") / n \
        if n else None
