"""Synthetic deterministic tree environment for tests and microbenchmarks.

A reproducible F-ary decision tree whose terminal rewards come from an
integer hash of the action history.  Deterministic, hashable, trivially
cheap — ideal for property tests of the in-tree machinery (the paper's
correctness claims are about the tree, not the game).

The port of repro.envs.bandit_tree: the numpy halves, and the device
twins the fused K-superstep dispatch runs (torch ops on the states'
device, bit-equal to the numpy halves; envs.device).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.envs.device import hash24_device

_M64 = (1 << 64) - 1


def _hash(h: int, a: int) -> int:
    """splitmix-style mix; result masked to 24 bits so it round-trips
    exactly through the f32 ST entry."""
    x = (int(h) ^ ((int(a) + 0x9E3779B97F4A7C15 + (int(h) << 6)) & _M64)) & _M64
    x = (x * 0xBF58476D1CE4E5B9) & _M64
    x ^= x >> 31
    return int(x & 0xFFFFFF)


def _hash_batch(h: np.ndarray, a) -> np.ndarray:
    """Vectorized _hash: uint64 wrap-around arithmetic is exactly the
    scalar's mod-2^64 masking, element for element."""
    h = np.asarray(h).astype(np.uint64)
    a = np.broadcast_to(np.asarray(a), h.shape).astype(np.uint64)
    x = h ^ (a + np.uint64(0x9E3779B97F4A7C15) + (h << np.uint64(6)))
    x = x * np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(31)
    return (x & np.uint64(0xFFFFFF)).astype(np.int64)


class BanditValueBackend:
    """Deterministic per-state simulation backend.

    The value is a pure function of the state's hash field, so evaluate()
    is invariant to batch composition and ordering — exactly what the
    service-layer equivalence tests need: a fused multi-tree batch must
    produce the same values as per-tree batches (a shared-RNG rollout
    backend would not, since interleaving changes its stream).
    """

    def evaluate(self, states):
        # NOTE: the op sequence is deliberately (exact integer subtract in
        # f32, then ONE rounded multiply), as in the JAX package, where a
        # device twin must reproduce it bit for bit.  (m - 1000) is
        # exact: |m - 1000| < 2^11.
        h = np.asarray(states)[:, 1].astype(np.int64)
        m = (_hash_batch(h, 4242) % 2000).astype(np.float32)
        return (m - np.float32(1000.0)) * np.float32(1e-3), None

    def evaluate_device(self, states: torch.Tensor) -> torch.Tensor:
        """Device twin of evaluate(): bit-equal values (see NOTE).  Two
        eager ops, so nothing can contract them into an FMA; the factor
        is the f32 tensor of 1e-3, the numpy half's np.float32(1e-3)."""
        m = (hash24_device(states[..., 1], 4242) % 2000).to(torch.float32)
        milli = torch.full((), 1e-3, dtype=torch.float32, device=states.device)
        return (m - 1000.0) * milli


class BanditTreeEnv:
    """State: f32[8] = [depth, hash, terminal, n_actions, 0...]."""

    state_shape = (8,)
    state_dtype = np.float32

    def __init__(self, fanout: int = 6, terminal_depth: int = 12,
                 varying_fanout: bool = False):
        self.F = fanout
        self.max_actions = fanout
        self.terminal_depth = terminal_depth
        self.varying_fanout = varying_fanout

    def _na(self, h: int, depth: int) -> int:
        if depth >= self.terminal_depth:
            return 0
        if self.varying_fanout:
            return 1 + _hash(h, 7777) % self.F
        return self.F

    def initial_state(self, seed: int) -> np.ndarray:
        s = np.zeros(8, np.float32)
        h = _hash(seed, 12345)
        s[1] = h
        s[3] = self._na(h, 0)
        return s

    def num_actions(self, state: np.ndarray) -> int:
        return int(state[3])

    def step(self, state: np.ndarray, a: int):
        d, h = int(state[0]), int(state[1])
        assert 0 <= a < self._na(h, d), (a, self._na(h, d))
        h2, d2 = _hash(h, a), d + 1
        term = d2 >= self.terminal_depth
        s = np.zeros(8, np.float32)
        s[0], s[1] = d2, h2
        s[2] = float(term)
        s[3] = self._na(h2, d2)
        # dense shaped reward in [-0.5, 0.5], deterministic per transition
        r = (_hash(h2, 999) % 1000) / 1000.0 - 0.5
        return s, float(r), term

    # ---- VectorEnv (envs.vector): batched twin, bit-identical to step ----

    def _na_batch(self, h: np.ndarray, depth: np.ndarray) -> np.ndarray:
        if self.varying_fanout:
            na = 1 + _hash_batch(h, 7777) % self.F
        else:
            na = np.full(len(h), self.F, np.int64)
        return np.where(depth >= self.terminal_depth, 0, na)

    def num_actions_batch(self, states: np.ndarray) -> np.ndarray:
        return np.asarray(states)[:, 3].astype(np.int64)

    def step_batch(self, states: np.ndarray, actions: np.ndarray):
        states = np.asarray(states, np.float32)
        a = np.asarray(actions).astype(np.int64)
        d = states[:, 0].astype(np.int64)
        h = states[:, 1].astype(np.int64)
        na = self._na_batch(h, d)
        assert ((a >= 0) & (a < na)).all(), "illegal action in batch"
        h2, d2 = _hash_batch(h, a), d + 1
        term = d2 >= self.terminal_depth
        s = np.zeros((len(a), 8), np.float32)
        s[:, 0] = d2
        s[:, 1] = h2
        s[:, 2] = term
        s[:, 3] = self._na_batch(h2, d2)
        r = (_hash_batch(h2, 999) % 1000) / 1000.0 - 0.5
        return s, r, term

    # ---- device twins (envs.device): torch ops, bit-identical ----
    #
    # No rewards on the device: the fused dispatch only resolves
    # expansions; rewards are consumed at move commits, on the host.
    # Every field round-trips exactly through f32 (depth < 2^24, 24-bit
    # hash, 0/1 terminal flag, n_actions <= F).

    def _na_device(self, h: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
        if self.varying_fanout:
            na = 1 + hash24_device(h, 7777) % self.F
        else:
            na = torch.full(h.shape, self.F, dtype=torch.int32, device=h.device)
        return torch.where(depth >= self.terminal_depth, 0, na)

    def num_actions_device(self, states: torch.Tensor) -> torch.Tensor:
        return states[..., 3].to(torch.int32)

    def step_device(self, states: torch.Tensor, actions: torch.Tensor):
        d = states[..., 0].to(torch.int32)
        h2 = hash24_device(states[..., 1], actions)
        d2 = d + 1
        term = d2 >= self.terminal_depth
        cols = torch.stack([d2, h2, term.to(torch.int32),
                            self._na_device(h2, d2)], -1).to(states.dtype)
        s = torch.zeros_like(states)
        s[..., :4] = cols
        return s, term
