"""Gomoku roots for the program: a GomokuEnv whose initial_state(seed)
is the opening registered under that seed.

The port's GomokuEnv starts every search from the empty board; the
benchmark's traffic starts each from its own opening.  Everything but
initial_state is the port's GomokuEnv, inherited unchanged (step,
num_actions and the batched VectorEnv forms the expansion engine calls).
"""

from __future__ import annotations

import numpy as np
from repro_torch.envs import GomokuEnv


class OpeningGomoku(GomokuEnv):
    def __init__(self):
        self.roots: dict = {}

    def register(self, seed: int, actions) -> None:
        """The position after `actions` from the empty board, played
        with the port's own rules, becomes the root of `seed`."""
        s = super().initial_state(0)
        for a in actions:
            s, _, _ = self.step(s, int(a))
        self.roots[int(seed)] = s

    def initial_state(self, seed: int = 0) -> np.ndarray:
        return self.roots[int(seed)].copy()
