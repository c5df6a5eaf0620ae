"""Gomoku (paper benchmark b): 6x6 board, 4-in-row, F = 36, D = 5, X = 48K.

Mirrors the paper's second benchmark [9] (junxiaosong/AlphaZero_Gomoku):
small board, n-in-row win, the Expansion phase expands *all* legal children
of a selected leaf, and the Simulation phase is policy-value inference
(see envs/policy_net.py) or a random playout fallback.

State is 108 f32 words = 432 bytes — byte-identical ST traffic to the
paper's reported Gomoku state size.

Layout: [0] player-to-move (+1/-1)  [1] terminal  [2] winner (+1/-1/0)
        [3:39] board cells (row-major; 0 empty, +1, -1); [39:108] pad.

Action index `a` at a state = the a-th empty cell in row-major order
(stable per state, matching the driver's action-indexing contract).
"""

from __future__ import annotations

import numpy as np

_BOARD = 6
_CELLS = _BOARD * _BOARD
_WIN = 4
_N = 108  # 432 bytes


class GomokuEnv:
    state_shape = (_N,)
    state_dtype = np.float32
    max_actions = _CELLS

    def initial_state(self, seed: int = 0) -> np.ndarray:
        s = np.zeros(_N, np.float32)
        s[0] = 1.0
        return s

    @staticmethod
    def board(state: np.ndarray) -> np.ndarray:
        return state[3 : 3 + _CELLS].reshape(_BOARD, _BOARD)

    def num_actions(self, state: np.ndarray) -> int:
        if state[1]:
            return 0
        return int(np.sum(state[3 : 3 + _CELLS] == 0))

    @staticmethod
    def legal_cells(state: np.ndarray) -> np.ndarray:
        return np.flatnonzero(state[3 : 3 + _CELLS] == 0)

    def step(self, state: np.ndarray, a: int):
        s = state.copy()
        assert not s[1]
        cells = self.legal_cells(s)
        cell = int(cells[a])
        player = s[0]
        s[3 + cell] = player
        r, c = divmod(cell, _BOARD)
        if _wins(self.board(s), r, c, player):
            s[1], s[2] = 1.0, player
            reward = 1.0          # from the mover's perspective
        elif len(cells) == 1:     # board full -> draw
            s[1], s[2] = 1.0, 0.0
            reward = 0.0
        else:
            reward = 0.0
        s[0] = -player
        return s, float(reward), bool(s[1])

    # ---- VectorEnv (envs.vector): batched twin, bit-identical to step ----

    def num_actions_batch(self, states: np.ndarray) -> np.ndarray:
        states = np.asarray(states, np.float32)
        empties = (states[:, 3 : 3 + _CELLS] == 0).sum(1)
        return np.where(states[:, 1] != 0, 0, empties).astype(np.int64)

    def step_batch(self, states: np.ndarray, actions: np.ndarray):
        s = np.asarray(states, np.float32).copy()
        a = np.asarray(actions).astype(np.int64)
        B = len(s)
        assert not s[:, 1].any(), "step_batch on terminal state"
        board = s[:, 3 : 3 + _CELLS]            # view: writes land in s
        empty = board == 0
        n_empty = empty.sum(1)
        assert ((a >= 0) & (a < n_empty)).all(), "illegal action in batch"
        # the a-th empty cell in row-major order, per row
        target = empty & (np.cumsum(empty, axis=1) == (a + 1)[:, None])
        cell = target.argmax(1)
        player = s[:, 0].copy()
        rows = np.arange(B)
        board[rows, cell] = player
        r, c = np.divmod(cell, _BOARD)
        win = _wins_batch(board.reshape(B, _BOARD, _BOARD), r, c, player)
        draw = ~win & (n_empty == 1)            # move filled the last cell
        terminal = win | draw
        s[:, 1] = terminal
        s[:, 2] = np.where(win, player, 0.0)
        s[:, 0] = -player
        reward = np.where(win, 1.0, 0.0)        # mover's perspective
        return s, reward, terminal


def _wins_batch(boards: np.ndarray, r: np.ndarray, c: np.ndarray,
                player: np.ndarray) -> np.ndarray:
    """Batched _wins: contiguous-run length through the placed cell per
    direction, counted with a bounded offset sweep (runs longer than _WIN
    still win, exactly as the scalar while-loop)."""
    B = len(r)
    rows = np.arange(B)
    win = np.zeros(B, bool)
    for dr, dc in ((0, 1), (1, 0), (1, 1), (1, -1)):
        n = np.ones(B, np.int64)
        for sgn in (1, -1):
            alive = np.ones(B, bool)
            for i in range(1, _WIN):
                rr = r + sgn * dr * i
                cc = c + sgn * dc * i
                inb = (rr >= 0) & (rr < _BOARD) & (cc >= 0) & (cc < _BOARD)
                val = boards[rows, np.clip(rr, 0, _BOARD - 1),
                             np.clip(cc, 0, _BOARD - 1)]
                alive &= inb & (val == player)
                n += alive
        win |= n >= _WIN
    return win


def _wins(board: np.ndarray, r: int, c: int, player: float) -> bool:
    for dr, dc in ((0, 1), (1, 0), (1, 1), (1, -1)):
        n = 1
        for sgn in (1, -1):
            rr, cc = r + sgn * dr, c + sgn * dc
            while 0 <= rr < _BOARD and 0 <= cc < _BOARD and board[rr, cc] == player:
                n += 1
                rr += sgn * dr
                cc += sgn * dc
        if n >= _WIN:
            return True
    return False


class GomokuRolloutBackend:
    """Random-playout evaluator; returns value from the perspective of the
    player to move at the given state (AlphaZero convention, used with
    alternating_signs=True in the driver)."""

    def __init__(self, env: GomokuEnv, seed: int = 0):
        self.env = env
        self.rng = np.random.RandomState(seed)

    def evaluate(self, states: np.ndarray):
        vals = np.zeros(len(states), np.float32)
        for i, s in enumerate(states):
            vals[i] = self._value(s)
        return vals, None

    def _value(self, state: np.ndarray) -> float:
        me = state[0]
        if state[1]:
            w = state[2]
            return 0.0 if w == 0 else (1.0 if w == me else -1.0)
        s = state
        while not s[1]:
            k = self.env.num_actions(s)
            s, _, _ = self.env.step(s, int(self.rng.randint(k)))
        w = s[2]
        return 0.0 if w == 0 else (1.0 if w == me else -1.0)
