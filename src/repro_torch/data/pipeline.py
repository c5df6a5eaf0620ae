"""Data pipeline: deterministic synthetic token stream + host prefetch
(a copy of repro.data.pipeline, which is numpy only; the port imports
nothing of the JAX package).

Determinism contract (fault tolerance): batch(step) is a pure function of
(seed, step), so a restart from checkpoint step k replays the identical
stream — no data-state checkpointing needed.

The synthetic stream is a mixture of Zipf-distributed unigrams and short
repeated motifs, giving a learnable distribution (loss decreases) rather
than uniform noise — used by the end-to-end training example.
"""

from __future__ import annotations

import queue
import threading

import numpy as np


class SyntheticTokens:
    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0,
                 zipf_a: float = 1.3, motif_len: int = 8, n_motifs: int = 64):
        self.vocab, self.batch, self.seq = vocab, batch, seq
        self.seed = seed
        rng = np.random.RandomState(seed)
        self.motifs = rng.randint(
            0, vocab, size=(n_motifs, motif_len)).astype(np.int32)
        self.zipf_a = zipf_a

    def batch_at(self, step: int) -> dict:
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + step) % (2**31 - 1))
        z = rng.zipf(self.zipf_a, size=(self.batch, self.seq + 1))
        toks = (z - 1) % self.vocab
        # overwrite random spans with motifs (predictable structure)
        n_spans = self.seq // 32
        for b in range(self.batch):
            idx = rng.randint(0, len(self.motifs), size=n_spans)
            pos = rng.randint(0, self.seq - self.motifs.shape[1],
                              size=n_spans)
            for m, p0 in zip(idx, pos):
                toks[b, p0 : p0 + self.motifs.shape[1]] = self.motifs[m]
        toks = toks.astype(np.int32)
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
            "mask": np.ones((self.batch, self.seq), np.float32),
        }


class Prefetcher:
    """Host-side prefetch thread: overlaps batch synthesis/IO with device
    compute (depth-bounded queue)."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        s = self.step
        while not self._stop.is_set():
            b = self.source.batch_at(s)
            while not self._stop.is_set():
                try:
                    self.q.put((s, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            s += 1

    def next(self):
        return self.q.get()

    def close(self):
        self._stop.set()
