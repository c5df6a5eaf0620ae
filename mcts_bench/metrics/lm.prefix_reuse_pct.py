"""Share of the prefix tokens the LM's forwards needed that a root
snapshot held: lm_prefix_tokens_reused_total over it plus the tokens
forwarded by prompt prefills and suffix forwards (decode steps are not
prefix work), in percent."""

from mcts_bench.lm_counts import phase

TOKENS = "lm_tokens_forwarded_total"


def read(ctx):
    reused = ctx.counter("lm_prefix_tokens_reused_total")
    run = phase(ctx, TOKENS, "prompt") + phase(ctx, TOKENS, "suffix")
    if not reused + run:
        return None
    return 100.0 * reused / (reused + run)
