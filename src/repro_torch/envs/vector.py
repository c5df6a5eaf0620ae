"""VectorEnv — batched host-environment stepping for the expansion engine.

The paper's CPU side runs p workers' expansion/simulation concurrently
while the FPGA serves the in-tree phases; our host analogue is the
expansion engine (core.expand), which flattens every pending expansion of
every tree slot into ONE [B] batch.  This module defines the contract the
engine consumes and the process-pool fallback for environments that have
no vectorized form:

  VectorEnv      — protocol: step [B] states x [B] actions in one call and
                   count legal actions for [B] states in one call.  The
                   port's envs (bandit_tree / ponglite) implement it
                   natively with numpy array programs that are
                   bit-identical to their scalar ``step``.
  PoolVectorEnv  — wraps a scalar Environment behind the same protocol by
                   chunking the batch over a process pool of workers each
                   holding an env replica — the multi-worker CPU side of
                   the paper, for envs where a numpy rewrite is not worth
                   it.  Deterministic: chunk boundaries depend only on
                   (B, workers) and results are concatenated in order.
                   It also serves the fused ``step_and_count_batch`` (one
                   round trip for step + successor action counts) and its
                   non-blocking ``submit_batch`` / ``collect`` split, the
                   overlap serving mode's host half: the workers step
                   their chunks while the caller's thread runs another
                   gang's superstep.

The workers are spawned processes holding numpy env replicas only: they
never touch CUDA (``probe_workers`` asks each one).
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np


@runtime_checkable
class VectorEnv(Protocol):
    """Batched twin of core.mcts.Environment.

    Implementations must be bit-identical to looping the scalar ``step``
    / ``num_actions`` over the batch — the expansion engine relies on it
    for the loop/vector bit-equivalence.
    """

    def step_batch(self, states: np.ndarray, actions: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """[B, ...] states x [B] actions -> (next_states [B, ...],
        rewards [B] f64, terminal [B] bool)."""
        ...

    def num_actions_batch(self, states: np.ndarray) -> np.ndarray:
        """[B, ...] states -> [B] legal-action counts (0 when terminal)."""
        ...


def has_vector_env(env) -> bool:
    """True when `env` natively implements the VectorEnv protocol."""
    return callable(getattr(env, "step_batch", None)) and callable(
        getattr(env, "num_actions_batch", None))


def has_fused_step(venv) -> bool:
    """True when `venv` implements the optional fused
    ``step_and_count_batch`` extension (one round trip for step +
    legal-action count — PoolVectorEnv's IPC halving)."""
    return callable(getattr(venv, "step_and_count_batch", None))


def has_async_step(venv) -> bool:
    """True when `venv` implements the non-blocking ``submit_batch`` /
    ``collect`` split of the fused step (the overlap serving mode's
    host-side pipelining hook)."""
    return (callable(getattr(venv, "submit_batch", None))
            and callable(getattr(venv, "collect", None)))


# --------------------------------------------------------------------------
# Process-pool fallback (paper's multi-worker CPU side)
# --------------------------------------------------------------------------

_WORKER_ENV = None  # per-process env replica (set by the pool initializer)


def _pool_init(env):
    global _WORKER_ENV
    _WORKER_ENV = env


def _pool_step_chunk(payload):
    states, actions = payload
    nxt, rew, term = [], [], []
    for s, a in zip(states, actions):
        s2, r, t = _WORKER_ENV.step(s, int(a))
        nxt.append(s2)
        rew.append(r)
        term.append(t)
    return (np.stack(nxt), np.asarray(rew, np.float64),
            np.asarray(term, bool))


def _pool_na_chunk(states):
    return np.asarray([_WORKER_ENV.num_actions(s) for s in states], np.int64)


def _pool_step_na_chunk(payload):
    """Fused chunk: step AND count the successor's legal actions in the
    worker, so the successor states never round-trip through pickling
    just to be counted."""
    states, actions = payload
    nxt, rew, term, na = [], [], [], []
    for s, a in zip(states, actions):
        s2, r, t = _WORKER_ENV.step(s, int(a))
        nxt.append(s2)
        rew.append(r)
        term.append(t)
        na.append(_WORKER_ENV.num_actions(s2))
    return (np.stack(nxt), np.asarray(rew, np.float64),
            np.asarray(term, bool), np.asarray(na, np.int64))


def _pool_probe(delay: float):
    """(pid, whether this worker has initialised CUDA).  The delay keeps
    a worker busy so that a batch of probes spreads over every worker."""
    import os
    import sys
    import time

    time.sleep(delay)
    torch = sys.modules.get("torch")
    return os.getpid(), bool(torch is not None and torch.cuda.is_initialized())


class PendingBatch:
    """Handle for an in-flight submit_batch: the posted chunk futures, or
    the already-computed result when the batch was small enough to step
    inline (no IPC).  One-shot: collect() consumes it."""

    __slots__ = ("futures", "result")

    def __init__(self, futures=None, result=None):
        self.futures = futures
        self.result = result


class PoolVectorEnv:
    """Scalar env behind the VectorEnv protocol via a process pool.

    Workers are spawned lazily on first use (so constructing the engine
    is free) and each holds its own env replica, rebuilt from the pickled
    env by the pool initializer; batches are chunked into at most
    `workers` contiguous pieces whose results are concatenated in
    submission order — the output is bit-identical to a scalar loop for
    any deterministic env.  Call close() (or use as a context manager)
    when done; idle pools also die with the parent process.
    """

    def __init__(self, env, workers: int = 2):
        self.env = env
        self.workers = max(1, int(workers))
        self._pool = None
        # batched round trips served (the fused call counts once)
        self.batch_calls = 0

    def _ensure_pool(self):
        if self._pool is None:
            import multiprocessing
            from concurrent.futures import ProcessPoolExecutor
            # spawn, not fork: the parent typically has torch threads live,
            # and forking a multithreaded process can deadlock
            self._pool = ProcessPoolExecutor(
                max_workers=self.workers, initializer=_pool_init,
                initargs=(self.env,),
                mp_context=multiprocessing.get_context("spawn"))
        return self._pool

    def _chunks(self, n: int) -> list:
        bounds = np.linspace(0, n, self.workers + 1).astype(int)
        return [(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])
                if b > a]

    def step_batch(self, states, actions):
        states = np.asarray(states)
        actions = np.asarray(actions)
        spans = self._chunks(len(states))
        self.batch_calls += 1
        if len(spans) <= 1:  # tiny batch: skip the IPC round-trip
            _pool_init(self.env)
            out = [_pool_step_chunk((states, actions))]
        else:
            out = list(self._ensure_pool().map(
                _pool_step_chunk,
                [(states[a:b], actions[a:b]) for a, b in spans]))
        return (np.concatenate([o[0] for o in out]),
                np.concatenate([o[1] for o in out]),
                np.concatenate([o[2] for o in out]))

    def num_actions_batch(self, states):
        states = np.asarray(states)
        spans = self._chunks(len(states))
        self.batch_calls += 1
        if len(spans) <= 1:
            _pool_init(self.env)
            return _pool_na_chunk(states)
        out = list(self._ensure_pool().map(
            _pool_na_chunk, [states[a:b] for a, b in spans]))
        return np.concatenate(out)

    def submit_batch(self, states, actions) -> PendingBatch:
        """Post the fused step + legal-action-count batch to the workers
        WITHOUT waiting: the states are pickled and posted once, here,
        and the handle is redeemed later with collect().  One
        `batch_calls` round trip, like the blocking fused call."""
        states = np.asarray(states)
        actions = np.asarray(actions)
        spans = self._chunks(len(states))
        self.batch_calls += 1
        if len(spans) <= 1:  # tiny batch: step inline, nothing in flight
            _pool_init(self.env)
            return PendingBatch(result=_pool_step_na_chunk((states, actions)))
        pool = self._ensure_pool()
        return PendingBatch(futures=[
            pool.submit(_pool_step_na_chunk, (states[a:b], actions[a:b]))
            for a, b in spans])

    def collect(self, pending: PendingBatch):
        """Block on a submit_batch handle and concatenate its chunks:
        (next_states, rewards, terminal, num_actions)."""
        if pending.result is not None:
            out = [pending.result]
        else:
            out = [f.result() for f in pending.futures]
        return tuple(np.concatenate([o[i] for o in out]) for i in range(4))

    def step_and_count_batch(self, states, actions):
        """Fused step + legal-action count: ONE pooled round trip instead
        of step_batch followed by num_actions_batch.  Returns
        (next_states, rewards, terminal, num_actions), bit-identical to
        the two-call form; collect(submit_batch(...))."""
        return self.collect(self.submit_batch(states, actions))

    def probe_workers(self, rounds: int = 4, delay: float = 0.2) -> dict:
        """{pid: CUDA initialised?} over the worker processes (started
        if they are not yet): `rounds` probes a worker, each holding its
        worker `delay` seconds so that every worker takes some."""
        pool = self._ensure_pool()
        futs = [pool.submit(_pool_probe, delay)
                for _ in range(rounds * self.workers)]
        return dict(f.result() for f in futs)

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
