"""Milliseconds a superstep the LM spends expanding: the program's
`lm-expand` spans (a state's forward past its root snapshot and the host
top-F) over the window's supersteps."""

from mcts_bench import lm_counts


def read(ctx):
    return lm_counts.ms_per_superstep(ctx, "lm-expand")
