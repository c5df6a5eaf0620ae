"""The generator: blocks that hold the same work for every seed."""

import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(REPO), str(REPO / "src")]

from mcts_bench import manifest  # noqa: E402
from mcts_bench.traffic.generator import (  # noqa: E402
    Searches, opening, spread, zipf_counts,
)


def test_spread_spans_both_ends():
    s = spread(128, 512, 64)
    assert len(s) == 64 and s[0] == 128 and s[-1] == 512
    assert np.all(np.diff(s) >= 0)
    assert list(spread(1, 1, 5)) == [1] * 5


@pytest.mark.parametrize("cell", ["pong.think_long", "gomoku.selfplay",
                                  "pong.blitz", "gomoku.book_repeat"])
def test_every_seed_gets_the_same_work(cell):
    p = manifest.workload(cell)["searches"]
    n = p["block"]
    a, b = Searches(p, 1), Searches(p, 2 ** 31 + 9)
    for _ in range(3):
        sa = [a.next() for _ in range(n)]
        sb = [b.next() for _ in range(n)]
        sizes = lambda ss: Counter((s["budget"], s["moves"],
                                    len(s.get("opening", ())),
                                    s.get("book")) for s in ss)
        assert sizes(sa) == sizes(sb)
        # in another order, from other roots
        order = lambda ss: [(s["budget"], s["moves"], s.get("book"),
                             tuple(s.get("opening", ())),
                             s["seed"] if "opening" not in s else None)
                            for s in ss]
        assert order(sa) != order(sb)


def test_same_seed_same_stream():
    p = manifest.workload("gomoku.selfplay")["searches"]
    a, b = Searches(p, 77), Searches(p, 77)
    assert [a.next() for _ in range(100)] == [b.next() for _ in range(100)]


def test_openings_are_legal_and_short_of_a_win():
    rng = np.random.default_rng(0)
    for k in range(7):
        o = opening(rng, 36, k)
        assert len(o) == k and all(0 <= a < 36 - i for i, a in enumerate(o))
    with pytest.raises(ValueError):
        opening(rng, 36, 7)


def test_book_is_zipf_and_fixed():
    p = manifest.workload("gomoku.book_repeat")["searches"]
    r = p["roots"]
    counts = zipf_counts(r["size"], r["zipf_s"], p["block"])
    assert counts.sum() == p["block"] and np.all(np.diff(counts) <= 0)
    a, b = Searches(p, 3), Searches(p, 4)
    assert a.book == b.book and len(a.book) == r["size"]
    got = Counter(a.next()["book"] for _ in range(p["block"]))
    assert [got.get(i, 0) for i in range(r["size"])] == list(counts)
