"""The LM path's spans and counters over the window (sim.lm and
serving.batcher of the program): per superstep, per committed move and
by phase.  A program that keeps none of them reads None."""

from mcts_bench import spans

ROLLOUT = ("lm-admit", "lm-decode", "lm-logprob")


def phase(ctx, counter: str, name: str) -> float:
    """A counter's growth in one phase over the window."""
    return float(ctx.registry.get(counter, {}).get(
        f'{counter}{{phase="{name}"}}', 0))


def ms_per_superstep(ctx, *names: str):
    n = ctx.stats["supersteps"]
    if not n or not any(spans.count(ctx, s) for s in names):
        return None
    return 1e3 * spans.seconds(ctx, *names) / n
