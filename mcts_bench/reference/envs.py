"""The plain environments: the seeded bandit tree with its value, and
6x6 Gomoku (four in a row).  Scalar, one state at a time; frozen copies of
the rules the benchmark's configurations state, independent of the
program under test.
"""

from __future__ import annotations

import numpy as np

_M64 = (1 << 64) - 1


def mix24(h: int, a: int) -> int:
    """splitmix-style mix masked to 24 bits (exact in an f32 state word)."""
    x = (int(h) ^ ((int(a) + 0x9E3779B97F4A7C15 + (int(h) << 6)) & _M64)) & _M64
    x = (x * 0xBF58476D1CE4E5B9) & _M64
    x ^= x >> 31
    return int(x & 0xFFFFFF)


class BanditTree:
    """State f32[8] = [depth, hash, terminal, n_actions, 0...]; a fixed
    fanout until `terminal_depth`; reward and value are functions of the
    24-bit hash alone."""

    state_words = 8

    def __init__(self, fanout: int, terminal_depth: int):
        self.F, self.terminal_depth = int(fanout), int(terminal_depth)

    def _na(self, depth: int) -> int:
        return 0 if depth >= self.terminal_depth else self.F

    def initial_state(self, seed: int) -> np.ndarray:
        s = np.zeros(8, np.float32)
        s[1] = mix24(seed, 12345)
        s[3] = self._na(0)
        return s

    def num_actions(self, s) -> int:
        return int(s[3])

    def step(self, s, a: int):
        d2, h2 = int(s[0]) + 1, mix24(int(s[1]), a)
        out = np.zeros(8, np.float32)
        out[0], out[1] = d2, h2
        out[2] = float(d2 >= self.terminal_depth)
        out[3] = self._na(d2)
        reward = (mix24(h2, 999) % 1000) / 1000.0 - 0.5
        return out, float(reward), d2 >= self.terminal_depth

    @staticmethod
    def values(states: np.ndarray, dtype=np.float32) -> np.ndarray:
        """(m - 1000) * 1e-3 in f32, m = mix24(hash, 4242) % 2000: one
        exact subtraction, one rounded product.  dtype="bfloat16" rounds
        the product to bfloat16 (the control's lower precision)."""
        m = np.array([mix24(int(h), 4242) % 2000 for h in states[:, 1]],
                     np.float32)
        v = (m - np.float32(1000.0)) * np.float32(1e-3)
        return round_bf16(v) if dtype == "bfloat16" else v


def round_bf16(x: np.ndarray) -> np.ndarray:
    """f32 -> the nearest bfloat16 (ties to even), held in f32."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) >> 16 << 16
    return b.astype(np.uint32).view(np.float32)


BOARD, CELLS, WIN, GOMOKU_WORDS = 6, 36, 4, 108


class Gomoku:
    """Layout: [0] player to move (+1/-1), [1] terminal, [2] winner,
    [3:39] the board row-major (0 empty); action a = the a-th empty cell."""

    state_words = GOMOKU_WORDS

    @staticmethod
    def empty() -> np.ndarray:
        s = np.zeros(GOMOKU_WORDS, np.float32)
        s[0] = 1.0
        return s

    def num_actions(self, s) -> int:
        return 0 if s[1] else int(np.sum(s[3:3 + CELLS] == 0))

    def step(self, s, a: int):
        s = s.copy()
        cells = np.flatnonzero(s[3:3 + CELLS] == 0)
        cell, player = int(cells[a]), s[0]
        s[3 + cell] = player
        r, c = divmod(cell, BOARD)
        board = s[3:3 + CELLS].reshape(BOARD, BOARD)
        reward = 0.0
        if _wins(board, r, c, player):
            s[1], s[2], reward = 1.0, player, 1.0
        elif len(cells) == 1:
            s[1], s[2] = 1.0, 0.0
        s[0] = -player
        return s, reward, bool(s[1])

    def play(self, actions) -> np.ndarray:
        """The position after `actions` from the empty board."""
        s = self.empty()
        for a in actions:
            s, _, _ = self.step(s, int(a))
        return s


def _wins(board, r: int, c: int, player) -> bool:
    for dr, dc in ((0, 1), (1, 0), (1, 1), (1, -1)):
        n = 1
        for sgn in (1, -1):
            rr, cc = r + sgn * dr, c + sgn * dc
            while 0 <= rr < BOARD and 0 <= cc < BOARD and board[rr, cc] == player:
                n += 1
                rr += sgn * dr
                cc += sgn * dc
        if n >= WIN:
            return True
    return False
