"""LM-decode-as-tree-search on torch: the environment and simulation
backend that plan over next-token actions with a language model (the
port of repro.sim.lm).

  * LMTreeEnv — states are token sequences (stored in the StateTable);
    actions are the top-F tokens the LM proposes at each node, from one
    full forward (a prefill through the flash kernel on the card); the
    horizon caps tree depth.
  * LMContinuationBackend — simulation value = the LM's mean token
    log-prob over a greedy continuation, decoded for every row together
    through ONE ContinuousBatcher pool.

With the port's TreeParallelMCTS this is the paper's system with the LM
as its simulation:

    env = LMTreeEnv(cfg, params, fanout=6, horizon=5)
    m = TreeParallelMCTS(TreeConfig(X=256, F=6, D=4), env,
                         LMContinuationBackend(env, pool_size=16), p=16,
                         expansion="loop")

States are float32 ``[len, tokens...]`` as in the JAX package; token ids
are exact in float32 below 2^24, which covers every vocabulary of the
repo's configs (llama3.2-1b: 128,256).

Determinism: the batcher's decode is greedy and its pool schedule is a
pure function of the submitted request stream, so evaluate() is
reproducible for a given states batch on one device.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.serving.batcher import ContinuousBatcher, Request

__all__ = ["MAXLEN", "LMTreeEnv", "LMContinuationBackend"]

MAXLEN = 48


class LMTreeEnv:
    """Token-sequence environment over an LM whose parameters live on
    the device the forwards run on.  ``impl`` is the prefill attention:
    "flash" (the kernel on the card, its plain version on the CPU) or
    "naive"."""

    state_dtype = np.float32

    def __init__(self, cfg, params, fanout: int = 6, horizon: int = 5,
                 impl: str = "flash"):
        self.cfg, self.params = cfg, params
        self.F, self.horizon, self.impl = fanout, horizon, impl
        self.device = params["embed"]["tok"].device
        self.state_shape = (MAXLEN + 1,)   # [len, tokens...]
        self.max_actions = fanout

    def initial_state(self, seed: int) -> np.ndarray:
        s = np.zeros(MAXLEN + 1, np.float32)
        s[0] = 1
        s[1] = 1 + seed % 7
        return s

    def tokens(self, state: np.ndarray) -> np.ndarray:
        n = int(state[0])
        return np.asarray(state[1 : 1 + n], np.int64)

    def top_actions(self, state: np.ndarray) -> np.ndarray:
        t = torch.as_tensor(self.tokens(state), device=self.device)[None]
        x, _ = lm.hidden_states(self.cfg, self.params, t, impl=self.impl)
        # the last position's logits (the JAX package unembeds all and
        # slices); host float32 and numpy's argsort, so ties order as in JAX
        logits = L.unembed(self.cfg, self.params["embed"], x[0, -1]).cpu().numpy()
        return np.argsort(-logits)[: self.F]

    def num_actions(self, state: np.ndarray) -> int:
        return 0 if int(state[0]) >= MAXLEN - self.horizon else self.F

    def step(self, state: np.ndarray, a: int):
        tok = int(self.top_actions(state)[a])
        s = state.copy()
        n = int(s[0])
        s[1 + n] = tok
        s[0] = n + 1
        return s, 0.0, int(s[0]) >= MAXLEN - self.horizon


class LMContinuationBackend:
    """Simulation = greedy LM continuation scored by mean log-prob,
    decoded for ALL rows concurrently through one ContinuousBatcher pool.

    ``pool_size`` is the LM serving microbatch: rows beyond it queue and
    admit as earlier continuations finish, so a batch of B rows costs
    ceil(B / pool_size) waves of `horizon` decode steps.  Its prefills
    use the env's attention ``impl``."""

    def __init__(self, env: LMTreeEnv, pool_size: int = 8, metrics=None):
        self.env = env
        self._uid = itertools.count()
        self.batcher = ContinuousBatcher(
            env.cfg, env.params, pool_size=pool_size,
            max_seq=MAXLEN + env.horizon + 2, impl=env.impl,
            record_logprobs=True, metrics=metrics)

    def bind_metrics(self, metrics) -> None:
        self.batcher.bind_metrics(metrics)

    def evaluate(self, states: np.ndarray):
        B = len(states)
        reqs = [Request(uid=next(self._uid),
                        prompt=self.env.tokens(states[i]).astype(np.int32),
                        max_new_tokens=self.env.horizon)
                for i in range(B)]
        self.batcher.completed = []
        for r in reqs:
            self.batcher.submit(r)
        done = self.batcher.run(
            max_steps=self.batcher.decode_steps + (B + 2) * self.env.horizon)
        if len(done) != B:
            raise RuntimeError(
                f"LM continuation pool drained {len(done)}/{B} rows")
        by_uid = {r.uid: r for r in done}
        vals = np.asarray(
            [np.float32(sum(by_uid[r.uid].logprobs) / self.env.horizon)
             for r in reqs], np.float32)
        return vals, None
