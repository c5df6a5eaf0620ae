"""Searches over the seeded bandit tree (the Pong configuration).

Program side: the port's SearchClient over BanditTreeEnv and
BanditValueBackend, both with device twins, so the client runs fused
K-superstep dispatches.  Reference side: the plain oracle over its own
bandit tree and value, from the same root seed: every committed move is
worked out again, bit for bit.
"""

from __future__ import annotations

import numpy as np

from mcts_bench.reference import envs as ref_envs
from mcts_bench.reference import search as ref_search
from mcts_bench.reference import tree as ref_tree
from mcts_bench.systems import make_client


def reference_moves(config: dict, spec: dict, n: int,
                    values_dtype=np.float32) -> list:
    """The first n moves of a search, by the plain reference, with the
    bandit's values in `values_dtype` (float32, as the configuration
    states, or "bfloat16" for the control)."""
    env = ref_envs.BanditTree(**config["env"])
    server = config["server"]
    return ref_search.run_search(
        ref_tree.Shape(**config["tree"]), env,
        lambda states: (ref_envs.BanditTree.values(states, values_dtype),
                        None),
        env.initial_state(spec["seed"]), server["p"], spec["budget"],
        spec["moves"], n, reuse_subtree=server["reuse_subtree"],
        alternating_signs=server["alternating_signs"])


class System:
    def __init__(self, config: dict, seed: int, device, trace: bool):
        from repro_torch.envs import BanditTreeEnv, BanditValueBackend

        self.config = config
        self.client = make_client(config, BanditTreeEnv(**config["env"]),
                                  BanditValueBackend(), device, trace)

    def request(self, spec: dict):
        from repro_torch.service import SearchRequest

        return SearchRequest(uid=spec["uid"], seed=spec["seed"],
                             budget=spec["budget"], moves=spec["moves"])

    def close(self) -> None:
        self.client.close()
        self.client = None

    def reference_moves(self, spec: dict, n: int) -> list:
        return reference_moves(self.config, spec, n)

    def extra_checks(self) -> dict:
        return {}
