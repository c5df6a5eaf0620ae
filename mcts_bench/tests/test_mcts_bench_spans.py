"""The metrics read from the program's span totals, on a traced small run
of each cell on the CPU: each is present and positive, and the window's
`commit` spans count the moves committed in it, to within the slots."""

import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(REPO), str(REPO / "src")]

from mcts_bench import cell, manifest, spans  # noqa: E402

SEED = 2 ** 31 + 211
SMALL = {
    "pong.blitz": dict(
        config=dict(tree=dict(X=1500), server=dict(G=3, p=8)),
        cell=dict(loop=dict(clients=6), warm_ticks=4, check_searches=1,
                  searches=dict(budget=[4, 10], moves=[2, 4]))),
    "gomoku.selfplay": dict(
        config=dict(tree=dict(X=1200), server=dict(G=2, p=8)),
        cell=dict(loop=dict(clients=4), warm_ticks=2, check_searches=1,
                  searches=dict(budget=[3, 6], moves=[1, 2]))),
}
SPAN_METRICS = {"commit.ms_per_move", "commit.copy_ms_per_move",
                "commit.reroot_ms_per_move", "commit.window_pct",
                "fused.collect_ms_per_dispatch", "service.unspanned_pct"}


@pytest.mark.parametrize("name", list(SMALL))
def test_span_metrics_on_a_traced_run(name):
    torch.set_num_threads(1)
    ctx = cell.measure(name, SEED, 2.0, True, device="cpu",
                       overrides=SMALL[name])
    _, layer = manifest.cell_metrics(manifest.benchmark(), name)
    wanted = [m["name"] for m in layer if m["name"] in SPAN_METRICS]
    assert set(wanted) == SPAN_METRICS - (
        set() if name == "pong.blitz" else {"fused.collect_ms_per_dispatch"})
    for metric in wanted:
        value = manifest.reader(metric)(ctx)
        assert value is not None and value > 0, metric
    G = ctx.config["server"]["G"]
    moves = len(ctx.loop.committed())
    assert moves > 0
    assert abs(spans.count(ctx, "commit") - moves) <= G
