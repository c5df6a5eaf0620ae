"""Rows a continuation admission's forward carried: the program's
lm_admit_forward_rows_total over lm_admit_forwards_total (a prompt
prefill or a B=1 extend carries one row, a batched extend a group of
rows of one suffix length).  A program that counts neither reads
None."""


def read(ctx):
    forwards = ctx.counter("lm_admit_forwards_total")
    if not forwards:
        return None
    return ctx.counter("lm_admit_forward_rows_total") / forwards
