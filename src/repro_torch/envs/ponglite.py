"""PongLite — deterministic Atari-Pong-like environment (paper benchmark a).

Matches the paper's Pong workload *shape*: fanout F = 6, tree height limit
D = 9, X = 56K nodes, and a 256-byte environment state (the paper reports
256 B/state ST entries for Pong) — here 64 f32 words, of which the first 8
are live physics and the rest zero padding so the ST traffic per operation
is byte-identical to the paper's.

Physics: a ball bounces in a unit box; the agent's paddle moves on the
right wall with 6 discrete velocity actions (Atari Pong's action set size).
Reward +1 on paddle hit, -1 on miss (episode ends), 0 otherwise.
Deterministic given (state, action).
"""

from __future__ import annotations

import numpy as np

# state layout: [0] ball_x [1] ball_y [2] vel_x [3] vel_y
#               [4] paddle_y [5] t [6] terminal [7] score ; [8:64] pad
_N = 64
_PAD_BYTES = _N * 4  # 256 B, as in the paper


class PongLiteEnv:
    state_shape = (_N,)
    state_dtype = np.float32
    max_actions = 6

    # paddle velocity per action id (Atari: NOOP/FIRE/UP/DOWN/UPFIRE/DOWNFIRE)
    _PADDLE_V = np.array([0.0, 0.0, 0.08, -0.08, 0.16, -0.16], np.float32)

    def __init__(self, max_t: int = 200):
        self.max_t = max_t

    def initial_state(self, seed: int) -> np.ndarray:
        rng = np.random.RandomState(seed)
        s = np.zeros(_N, np.float32)
        s[0], s[1] = 0.3, rng.uniform(0.2, 0.8)
        ang = rng.uniform(-0.9, 0.9)
        s[2], s[3] = 0.06, 0.06 * np.sin(ang)
        s[4] = 0.5
        return s

    def num_actions(self, state: np.ndarray) -> int:
        return 0 if state[6] else 6

    def step(self, state: np.ndarray, a: int):
        s = state.copy()
        assert not s[6]
        s[4] = np.clip(s[4] + self._PADDLE_V[a], 0.1, 0.9)
        s[0] += s[2]
        s[1] += s[3]
        if s[1] < 0.0 or s[1] > 1.0:            # top/bottom bounce
            s[3] = -s[3]
            s[1] = np.clip(s[1], 0.0, 1.0)
        if s[0] < 0.0:                           # left wall bounce
            s[2] = -s[2]
            s[0] = 0.0
        reward = 0.0
        if s[0] >= 1.0:                          # reaches paddle plane
            if abs(s[1] - s[4]) < 0.12:          # hit
                reward = 1.0
                s[7] += 1
                s[2] = -abs(s[2])
                s[3] += 0.25 * (s[1] - s[4])     # english
                s[0] = 1.0
            else:                                # miss -> terminal
                reward = -1.0
                s[6] = 1.0
        s[5] += 1
        if s[5] >= self.max_t:
            s[6] = 1.0
        return s, float(reward), bool(s[6])

    # ---- VectorEnv (envs.vector): batched twin, bit-identical to step ----
    # All arithmetic stays in f32 exactly as the scalar path (same ops on
    # the same dtype in the same order), so the results match bit for bit.

    def num_actions_batch(self, states: np.ndarray) -> np.ndarray:
        return np.where(np.asarray(states, np.float32)[:, 6] != 0, 0, 6
                        ).astype(np.int64)

    def step_batch(self, states: np.ndarray, actions: np.ndarray):
        s = np.asarray(states, np.float32).copy()
        a = np.asarray(actions).astype(np.int64)
        assert not s[:, 6].any(), "step_batch on terminal state"
        assert ((a >= 0) & (a < 6)).all(), "illegal action in batch"
        s[:, 4] = np.clip(s[:, 4] + self._PADDLE_V[a], 0.1, 0.9)
        s[:, 0] += s[:, 2]
        s[:, 1] += s[:, 3]
        bounce = (s[:, 1] < 0.0) | (s[:, 1] > 1.0)   # top/bottom bounce
        s[bounce, 3] = -s[bounce, 3]
        s[bounce, 1] = np.clip(s[bounce, 1], 0.0, 1.0)
        left = s[:, 0] < 0.0                         # left wall bounce
        s[left, 2] = -s[left, 2]
        s[left, 0] = 0.0
        plane = s[:, 0] >= 1.0                       # reaches paddle plane
        hit = plane & (np.abs(s[:, 1] - s[:, 4]) < 0.12)
        miss = plane & ~hit
        s[hit, 7] += 1
        s[hit, 2] = -np.abs(s[hit, 2])
        s[hit, 3] += np.float32(0.25) * (s[hit, 1] - s[hit, 4])  # english
        s[hit, 0] = 1.0
        s[miss, 6] = 1.0
        reward = np.where(hit, 1.0, np.where(miss, -1.0, 0.0))
        s[:, 5] += 1
        s[s[:, 5] >= self.max_t, 6] = 1.0
        return s, reward, s[:, 6] != 0
