"""The one generator of search requests, read from a cell's "searches".

A cell's traffic is a stream of searches, each a root, a budget of
supersteps a move and a number of moves.  The sizes come in blocks of
`block` searches (as many as the cell has clients): a block holds the
same searches' sizes in every run, each (budget, moves, opening plies)
paired the same way, and the run's seed permutes them and draws the
roots.  Two seeds then give the same work in another order: the seed
changes which searches meet, not how much there is.

Roots:
  seeded   - the environment's initial_state(seed) of a fresh 31-bit seed;
  openings - a fresh opening of `plies` random legal moves from the empty
             board of `cells` cells (each search its own);
  book     - one of `size` openings fixed by `book_seed`, drawn with
             Zipf(`zipf_s`) popularity (a block holds each opening about
             block x pmf times, by largest remainders).
Openings stop short of a possible win (`plies` < 7 on a four-in-a-row
board), so every ply's legal moves are the empty cells: cells - ply.
"""

from __future__ import annotations

import numpy as np


def spread(low: int, high: int, n: int) -> np.ndarray:
    """n integers evenly spread over [low, high], both ends included."""
    if n == 1 or high == low:
        return np.full(n, low, np.int64)
    return low + (np.arange(n) * (high - low)) // (n - 1)


def zipf_counts(size: int, s: float, n: int) -> np.ndarray:
    """How often each of `size` items appears among n draws of Zipf(s),
    rounded by largest remainders so that they add up to n."""
    pmf = 1.0 / np.arange(1, size + 1) ** s
    want = n * pmf / pmf.sum()
    counts = np.floor(want).astype(np.int64)
    rest = np.argsort(-(want - counts), kind="stable")[: n - counts.sum()]
    counts[rest] += 1
    return counts


def opening(rng: np.random.Generator, cells: int, plies: int) -> list:
    if plies >= 7:
        raise ValueError("openings of 7 or more plies may end the game")
    return [int(rng.integers(0, cells - k)) for k in range(plies)]


class Searches:
    """The seeded stream of search specs: dicts with uid, seed (the
    root's key), budget, moves and, for Gomoku roots, opening."""

    def __init__(self, searches: dict, seed: int):
        self.p = searches
        self.rng = np.random.default_rng(seed)
        self.block = int(searches.get("block", 64))
        self.roots = searches["roots"]
        self.uid = 0
        self._queue: list = []
        if self.roots["kind"] == "book":
            book_rng = np.random.default_rng(self.roots["book_seed"])
            lo, hi = self.roots["plies"]
            self.book = [opening(book_rng, self.roots["cells"],
                                 int(book_rng.integers(lo, hi + 1)))
                         for _ in range(self.roots["size"])]

    def _fill(self):
        n, rng = self.block, self.rng
        pairing = np.random.default_rng(n)    # the same for every seed
        budget = spread(*self.p["budget"], n)
        moves = pairing.permutation(spread(*self.p["moves"], n))
        kind = self.roots["kind"]
        if kind == "book":
            book = pairing.permutation(np.repeat(
                np.arange(self.roots["size"]),
                zipf_counts(self.roots["size"], self.roots["zipf_s"], n)))
        elif kind == "openings":
            plies = pairing.permutation(spread(*self.roots["plies"], n))
        elif kind != "seeded":
            raise ValueError(f"unknown root kind {kind!r}")
        for i in rng.permutation(n):
            if kind == "seeded":
                root = dict(seed=int(rng.integers(0, 1 << 31)))
            elif kind == "openings":
                root = dict(opening=opening(rng, self.roots["cells"],
                                            int(plies[i])))
            else:
                root = dict(book=int(book[i]), opening=self.book[book[i]])
            self._queue.append(dict(budget=int(budget[i]),
                                    moves=int(moves[i]), **root))

    def next(self) -> dict:
        if not self._queue:
            self._fill()
        spec = self._queue.pop(0)
        spec["uid"] = self.uid
        spec.setdefault("seed", spec.get("book", self.uid))
        self.uid += 1
        return spec
