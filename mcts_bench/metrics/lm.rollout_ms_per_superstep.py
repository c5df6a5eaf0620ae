"""Milliseconds a superstep the LM spends on continuations: the
program's `lm-admit` (a row's state copy and suffix prefill), `lm-decode`
(a batched decode step) and `lm-logprob` (the host log-probs) spans over
the window's supersteps."""

from mcts_bench import lm_counts


def read(ctx):
    return lm_counts.ms_per_superstep(ctx, *lm_counts.ROLLOUT)
