"""Gomoku searches with the policy-value net (the Gomoku configuration).

Program side: the port's SearchClient over GomokuEnv (each search from
its opening, traffic/openings.py) and the net behind
CachedSimBackend(SimServer(NNSimBackend)), the weights drawn on the
device from the run's seed.  The backend is wrapped so that every batch
the program simulated is kept with its answers.

Reference side, in two stages.  The net: the plain numpy net in float64
over the same weights gives each checked row's value and priors again,
and the program's answers are held to it within a limit (`value_gap`,
`prior_gap`); a state answered twice must be answered the same
(`conflicting_rows`).  The tree: the plain oracle replays each sampled
search from its opening with its own rules, taking each simulation's
answer from what the program's net gave for that state, and must commit
the same moves with the same visit counts.  The replay takes the
program's answers because the card's float32 rounding differs from the
reference's in the last bits, and a last-bit change moves a Qm.16 tree
statistic by one unit now and then; the net stage checks those answers
on their own.  Up to the first simulation whose value or priors round to
another Qm.16 integer on the two nets, a replay on the reference net's
own answers is the same computation as this one; `replay_info` runs that
independent replay too and reports how often, and after what, it departs
from the program (reported, not compared).
"""

from __future__ import annotations

import math

import numpy as np

from mcts_bench.reference import envs as ref_envs
from mcts_bench.reference import net as ref_net
from mcts_bench.reference import search as ref_search
from mcts_bench.reference import tree as ref_tree
from mcts_bench.systems import make_client

TRUNC = 0.87962566103423978   # std of a unit normal cut at +-2


def weight_shapes(C: int) -> list:
    """(name, shape, fan_in) of each weight, in the order they are drawn."""
    return [("c1", (C, 2, 3, 3), 2 * 9), ("c2", (C, C, 3, 3), C * 9),
            ("pol", (2, C, 1, 1), C), ("pol_w", (72, 36), 72),
            ("val_w1", (C * 36, 64), C * 36), ("val_w2", (64, 1), 64)]


def make_weights(C: int, seed: int, device) -> dict:
    """He-normal weights (a normal cut at two standard deviations, with
    variance 2 / fan_in), drawn on `device` in one call from `seed`."""
    import torch

    shapes = weight_shapes(C)
    sizes = [math.prod(s) for _, s, _ in shapes]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    out, off = {}, 0
    for (name, shape, fan_in), n in zip(shapes, sizes):
        std = math.sqrt(2.0 / fan_in) / TRUNC
        out[name] = (flat[off:off + n] * std).view(shape)
        off += n
    return out


class RecordingSim:
    """The program's simulation backend, keeping each batch it answered
    (its states, values and priors: the arrays the program made)."""

    def __init__(self, inner):
        self.inner = inner
        self.batches: list = []

    def bind_metrics(self, metrics) -> None:
        self.inner.bind_metrics(metrics)

    def evaluate(self, states):
        values, priors = self.inner.evaluate(states)
        self.batches.append((states, values, priors))
        return values, priors


class System:
    net_sample_rows = 2048     # rows of the whole record checked besides
    #                            those the replays read
    replay_searches = 8        # sampled searches also replayed on the
    #                            reference net's own answers

    def __init__(self, config: dict, seed: int, device, trace: bool):
        from repro_torch.envs.policy_net import NNSimBackend
        from repro_torch.sim import CachedSimBackend, SimServer

        from mcts_bench.traffic.openings import OpeningGomoku

        self.config, self.seed = config, int(seed)
        weights = make_weights(config["net"]["channels"], seed, device)
        self.weights = {k: v.detach().cpu().numpy().copy()
                        for k, v in weights.items()}
        self.env = OpeningGomoku()
        nn = NNSimBackend(self.env, weights, device=device)
        del weights
        s = config["sim"]
        self.sim = RecordingSim(CachedSimBackend(
            SimServer(nn, max_batch=s["max_batch"]),
            capacity=s["cache_capacity"]))
        self.client = make_client(config, self.env, self.sim, device, trace)
        self._index = None
        self.read: set = set()         # the states the replays read

    def request(self, spec: dict):
        from repro_torch.service import SearchRequest

        self.env.register(spec["seed"], spec["opening"])
        return SearchRequest(uid=spec["uid"], seed=spec["seed"],
                             budget=spec["budget"], moves=spec["moves"])

    def close(self) -> None:
        self.client.close()
        self.client = self.sim.inner = None

    # ---- reference ----
    def index(self) -> tuple:
        """{state bytes: (value, priors)} over every row the program
        answered, and how many states it answered twice differently."""
        if self._index is None:
            table, conflicts = {}, 0
            for states, values, priors in self.sim.batches:
                for i in range(len(states)):
                    key = states[i].tobytes()
                    got = table.get(key)
                    if got is None:
                        table[key] = (values[i], priors[i])
                    elif got[0] != values[i] or not np.array_equal(
                            got[1], priors[i]):
                        conflicts += 1
            self._index = (table, conflicts)
        return self._index

    def reference_moves(self, spec: dict, n: int) -> list:
        table, _ = self.index()
        missing = []

        def answers(states):
            values = np.zeros(len(states), np.float32)
            priors = np.zeros((len(states), ref_net.CELLS), np.float32)
            for i, s in enumerate(states):
                key = s.tobytes()
                got = table.get(key)
                if got is None:
                    missing.append(key)
                    continue
                values[i], priors[i] = got
                self.read.add(key)
            return values, priors

        env = ref_envs.Gomoku()
        server = self.config["server"]
        moves = ref_search.run_search(
            ref_tree.Shape(**self.config["tree"]), env, answers,
            env.play(spec["opening"]), server["p"], spec["budget"],
            spec["moves"], n, reuse_subtree=server["reuse_subtree"],
            alternating_signs=server["alternating_signs"])
        # a state the program never answered: the replay left its path
        return [] if missing else moves

    def replay_info(self, searches: list) -> dict:
        """The first `replay_searches` sampled searches replayed on the
        float64 reference net's own answers: how many depart from the program's moves, and of
        those how many met first a row whose value or priors round to
        another Qm.16 integer than the program's answer for that state
        (the rest met first a state the program never evaluated, or
        nothing, and are unexplained)."""
        searches = searches[:self.replay_searches]
        table, _ = self.index()
        server = self.config["server"]
        n = {"searches": len(searches), "apart": 0, "apart_after_rounding": 0,
             "rows": 0, "rows_rounded_apart": 0}
        for s in searches:
            first = []

            def answers(states):
                v, p = ref_net.evaluate(self.weights, states)
                v, p = v.astype(np.float32), p.astype(np.float32)
                for i, st in enumerate(states):
                    got = table.get(st.tobytes())
                    if got is None:
                        first.append("unknown")
                        continue
                    n["rows"] += 1
                    if (ref_tree.encode(v[i]) != ref_tree.encode(got[0])
                            or not np.array_equal(ref_tree.encode(p[i]),
                                                  ref_tree.encode(got[1]))):
                        n["rows_rounded_apart"] += 1
                        first.append("rounded")
                return v, p

            env = ref_envs.Gomoku()
            moves = ref_search.run_search(
                ref_tree.Shape(**self.config["tree"]), env, answers,
                env.play(s.spec["opening"]), server["p"], s.spec["budget"],
                s.spec["moves"], len(s.moves),
                reuse_subtree=server["reuse_subtree"],
                alternating_signs=server["alternating_signs"])
            same = len(moves) == len(s.moves) and all(
                a == b[0] and np.array_equal(v, b[1])
                for (a, v), b in zip(s.moves, moves))
            if not same:
                n["apart"] += 1
                n["apart_after_rounding"] += bool(first) and \
                    first[0] == "rounded"
        return n

    def checked_rows(self) -> tuple:
        """(states, program values, program priors) of the rows the net
        stage checks: every row the replays read, and a sample of the
        whole record drawn from the seed."""
        table, _ = self.index()
        keys = list(self.read)
        rng = np.random.default_rng(self.seed)
        every = list(table)
        take = rng.choice(len(every), min(self.net_sample_rows, len(every)),
                          replace=False) if every else []
        keys += [every[i] for i in take if every[i] not in self.read]
        if not keys:
            return np.zeros((0, ref_envs.GOMOKU_WORDS), np.float32), \
                np.zeros(0, np.float32), np.zeros((0, ref_net.CELLS), np.float32)
        states = np.stack([np.frombuffer(k, np.float32) for k in keys])
        values = np.array([table[k][0] for k in keys], np.float32)
        priors = np.stack([table[k][1] for k in keys]).astype(np.float32)
        return states, values, priors

    def extra_checks(self) -> dict:
        _, conflicts = self.index()
        states, values, priors = self.checked_rows()
        ref_v, ref_p = ref_net.evaluate(self.weights, states)
        return {
            "conflicting_rows": conflicts,
            "value_gap": float(np.abs(values - ref_v).max()) if len(states) else 0.0,
            "prior_gap": float(np.abs(priors - ref_p).max()) if len(states) else 0.0,
            "net_rows_checked": len(states),
        }
