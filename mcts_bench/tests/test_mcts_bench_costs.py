"""The byte and operation counts against hand counts at small shapes."""

import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(REPO), str(REPO / "src")]

from mcts_bench import manifest  # noqa: E402
from mcts_bench.cell import Context  # noqa: E402
from mcts_bench.costs import kernels, net, peaks  # noqa: E402

# one slot, two workers, D=3: worker 0 walks 0 -a2-> 1 -a0-> leaf 5,
# worker 1 walks 0 -a3-> leaf 4
SEL = dict(path_nodes=np.array([[[0, 1, -1], [0, -1, -1]]]),
           path_actions=np.array([[[2, 0, -1], [3, -1, -1]]]),
           leaves=np.array([[5, 4]]))


def test_select_cost_by_hand():
    # rows {0, 1} of 4 edge arrays x 8 lanes, nodes {0, 1, 4, 5} x 6 words;
    # virtual losses (0,2) (1,0) (0,3), the 4 nodes' counts, 2 x (2D + 5)
    # result words; 12 f32 operations a lane of each row
    assert kernels.select_cost(8, False, SEL, 3) == (
        (2 * 4 * 8 + 4 * 6) * 4 + (3 + 4 + 2 * 11) * 4, 2 * 8 * 12)
    # PUCT reads the priors too: a fifth edge array
    assert kernels.select_cost(8, True, SEL, 3)[0] == \
        (2 * 5 * 8 + 4 * 6) * 4 + (3 + 4 + 2 * 11) * 4


def test_backup_cost_by_hand():
    # 3 path edges + one a worker, 4 nodes + one a worker; 3 words an
    # edge and 2 a node, read and written; the 2 x (2D + 5) input words
    edges, nodes = 3 + 2, 4 + 2
    assert kernels.backup_cost(SEL, 3) == (
        2 * 11 * 4 + (edges * 3 + nodes * 2) * 4 * 2, edges * 3 + nodes * 2)


def test_model_paths_count_every_worker_at_depth_D():
    m = kernels.model_paths(G=2, p=4, D=3)
    assert m["path_nodes"].shape == (2, 4, 3) and m["leaves"].shape == (2, 4)
    b, f = kernels.select_cost(8, False, m, 3)
    # per slot: the root's row and 4 distinct rows at each of depths 1..2
    assert f == 2 * (1 + 4 * 2) * 8 * 12
    assert kernels.pad_fanout(6) == 8 and kernels.pad_fanout(36) == 64


@pytest.mark.parametrize("C,want", [
    # 36 x (C x 2 x 9 + C x C x 9 + 2 x C) + 72 x 36 + C x 36 x 64 + 64
    (32, 2 * (36 * 32 * 18 + 36 * 32 * 32 * 9 + 36 * 2 * 32 + 2592
              + 32 * 36 * 64 + 64)),
    (1, 2 * (648 + 324 + 72 + 2592 + 2304 + 64)),
])
def test_net_flops_by_hand(C, want):
    assert net.flops_per_row(C) == want
    if C == 32:
        assert abs(want - 0.86e6) < 0.01e6     # about 0.86 MFLOP a row


def test_bound_takes_the_larger_side():
    assert peaks.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 67e12) == pytest.approx(1.0)
    assert peaks.bound_s(3.35e12, 2 * 67e12) == pytest.approx(2.0)


def test_roofline_readers_over_a_slice():
    """Two launches of 10 us each: the share is a launch's bound over 10
    us, from the selections read back, or from the depth-D model."""
    config = dict(tree=dict(F=6, D=3, score_fn="uct"), server=dict(G=1, p=2))
    slice_ = dict(launches=[("void uct_select_kernel<1>(int)", 0.0, 10.0),
                            ("void uct_backup_kernel(int)", 10.0, 20.0),
                            ("void uct_select_kernel<1>(int)", 30.0, 40.0),
                            ("void uct_backup_kernel(int)", 40.0, 50.0)])
    ctx = Context(config=config, slice=slice_, selections=[SEL])
    sel = manifest.reader("uct_select_roofline")(ctx)
    assert sel == pytest.approx(
        100 * peaks.bound_s(*kernels.select_cost(8, False, SEL, 3)) / 10e-6)
    back = manifest.reader("uct_backup_roofline")(ctx)
    assert back == pytest.approx(
        100 * peaks.bound_s(*kernels.backup_cost(SEL, 3)) / 10e-6)
    ctx.selections = None
    model = kernels.model_paths(1, 2, 3)
    assert manifest.reader("uct_select_roofline")(ctx) == pytest.approx(
        100 * peaks.bound_s(*kernels.select_cost(8, False, model, 3)) / 10e-6)
    assert manifest.reader("device_idle_pct")(Context(slice=dict(
        busy_s=0.25, window_s=1.0))) == pytest.approx(75.0)
    assert manifest.reader("uct_select_roofline")(
        Context(config=config, slice=None, selections=None)) is None
