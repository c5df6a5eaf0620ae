"""The LM's share of the card's bf16 peak over the traced window: the
FLOPs of the tokens it forwarded (prompt prefills, suffix forwards and
decode rows), the keys they attended and the logits rows it unembedded
(the program's lm_* counters; costs/granite.py), over the window's
length and 989 TFLOP/s."""

from mcts_bench.costs import granite, peaks


def read(ctx):
    tokens = ctx.counter("lm_tokens_forwarded_total")
    if not tokens:
        return None
    flops = granite.flops(ctx.system.dims, tokens,
                          ctx.counter("lm_attention_keys_total"),
                          ctx.counter("lm_logit_rows_total"))
    return 100.0 * flops / ctx.window_s / peaks.BF16_FLOPS
