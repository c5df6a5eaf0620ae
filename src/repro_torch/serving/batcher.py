"""Continuous-batching serving loop for the LM simulation backend (the
port of repro.serving.batcher).

A fixed pool of B slots over ONE preallocated cache, with

  * slot-wise admission: a new request prefills into a free slot's cache
    row while the other slots keep decoding (continuous batching);
  * per-slot position tracking and eviction on EOS / max-tokens /
    max-seq;
  * deterministic greedy decoding;
  * backpressure: with ``max_pending`` set, a submit that would overgrow
    the waiting queue makes the SUBMITTER step the pool until the backlog
    fits; no request is ever dropped;
  * telemetry via obs.metrics (``serving_*`` gauges and counters).

Admission prefills the single prompt (B=1) straight into the pool
cache's slot row, in place: the row is a view of the pool's stacked
cache, so the prefill's cache writes land in the pool.  This is the
counterpart of the JAX package's prefill into a zeroed scratch cache and
splice (repro/serving/batcher.py:120-124).  The row's recurrent leaves
(SSD and RG-LRU: the conv context and the state, which a prefill starts
from) are zeroed first, or a slot's next occupant would start from the
last one's state.  Its old attention entries past the new prompt stay
behind, but decode masks every slot past the row's position, so they are
never read.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.models import lm, steps
from repro_torch.obs.metrics import NULL_REGISTRY


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # [S] int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    # filled by the batcher:
    tokens: list = dataclasses.field(default_factory=list)
    logprobs: list = dataclasses.field(default_factory=list)
    submitted_at: float = 0.0
    done_at: float = 0.0


def _logprob(logits_row: np.ndarray, tok: int) -> float:
    """Log-probability of one token under a logits row (host-side)."""
    l = np.asarray(logits_row, np.float32)
    return float(l[tok] - np.logaddexp.reduce(l))


def _slot_view(caches: dict, slot: int) -> dict:
    """The pool cache's row `slot` as [R, 1, ...] views of every leaf
    (k/v, conv/state, conv/h), with a scratch `pos` (the pool's own is the
    decode's, as in the JAX package)."""
    return {g: [{name: (torch.zeros_like(t) if name == "pos"
                        else t[:, slot:slot + 1]) for name, t in c.items()}
                for c in per_pos]
            for g, per_pos in caches.items()}


def _clear_recurrent(row: dict) -> None:
    """Zero a row view's recurrent leaves: a new sequence starts there."""
    for per_pos in row.values():
        for c in per_pos:
            for name in lm.RECURRENT_LEAVES:
                if name in c:
                    c[name].zero_()


class ContinuousBatcher:
    def __init__(self, cfg, params, pool_size: int = 8, max_seq: int = 256,
                 impl: str = "naive", max_pending: Optional[int] = None,
                 record_logprobs: bool = False, metrics=None):
        self.cfg, self.params = cfg, params
        self.device = params["embed"]["tok"].device
        self.B, self.max_seq = pool_size, max_seq
        self.max_pending = max_pending
        self.record_logprobs = record_logprobs
        self.caches = lm.init_caches(cfg, pool_size, max_seq, self.device)
        self._decode = steps.make_decode_step(cfg, impl=impl)
        self._prefill_one = steps.make_prefill_step(cfg, impl=impl)
        self.slots: list[Optional[Request]] = [None] * pool_size
        self.pos = np.zeros(pool_size, np.int64)       # next position per slot
        self.cur_tok = np.zeros((pool_size, 1), np.int32)
        self.queue: list[Request] = []
        self.completed: list[Request] = []
        self.decode_steps = 0
        self.bind_metrics(metrics)

    def bind_metrics(self, metrics) -> None:
        reg = NULL_REGISTRY if metrics is None else metrics
        self._m_occupancy = reg.gauge(
            "serving_pool_occupancy", "occupied decode slots / pool size")
        self._m_queue = reg.gauge(
            "serving_queue_depth", "requests waiting for a decode slot")
        self._m_admitted = reg.counter(
            "serving_admitted_total", "requests prefilled into a slot")
        self._m_completed = reg.counter(
            "serving_completed_total", "requests finished decoding")
        self._m_evicted = {reason: reg.counter(
            "serving_evictions_total", "slot evictions by cause",
            reason=reason) for reason in ("max_tokens", "eos", "max_seq")}

    def _occupied(self) -> int:
        return sum(s is not None for s in self.slots)

    def _set_gauges(self) -> None:
        self._m_occupancy.set(self._occupied() / self.B)
        self._m_queue.set(len(self.queue))

    # ---- admission ----
    def submit(self, req: Request):
        req.submitted_at = time.perf_counter()
        self.queue.append(req)
        # backpressure: never drop — the submitter drives the pool until
        # its request fits the waiting-queue bound
        if self.max_pending is not None:
            while len(self.queue) > self.max_pending:
                if not self.step():
                    break
        self._set_gauges()

    def _admit(self):
        for slot in range(self.B):
            if self.slots[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            prompt = torch.as_tensor(np.asarray(req.prompt, np.int64),
                                     device=self.device)[None]
            row = _slot_view(self.caches, slot)
            _clear_recurrent(row)
            logits, _ = self._prefill_one(self.params, prompt, row)
            self.slots[slot] = req
            self.pos[slot] = len(req.prompt)
            self.cur_tok[slot, 0] = int(torch.argmax(logits[0]))
            req.tokens.append(int(self.cur_tok[slot, 0]))
            if self.record_logprobs:
                req.logprobs.append(
                    _logprob(logits[0].cpu().numpy(), req.tokens[-1]))
            self._m_admitted.inc()
        self._set_gauges()

    # ---- decode tick ----
    def step(self):
        self._admit()
        if not any(s is not None for s in self.slots):
            return False
        # ragged continuous batching: per-row positions (idle slots pinned
        # to 0; their outputs are ignored)
        occupied = np.array([s is not None for s in self.slots])
        posv = torch.as_tensor(np.where(occupied, self.pos, 0).astype(np.int32),
                               device=self.device)
        tok = torch.as_tensor(self.cur_tok.astype(np.int64), device=self.device)
        logits, self.caches = self._decode(self.params, self.caches, tok, posv)
        self.decode_steps += 1
        host_logits = logits.cpu().numpy() if self.record_logprobs else None
        nxt = torch.argmax(logits, -1).to(torch.int32).cpu().numpy()
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            tok = int(nxt[slot])
            req.tokens.append(tok)
            if host_logits is not None:
                req.logprobs.append(_logprob(host_logits[slot], tok))
            self.pos[slot] += 1
            self.cur_tok[slot, 0] = tok
            reason = None
            if len(req.tokens) >= req.max_new_tokens:
                reason = "max_tokens"
            elif req.eos_id is not None and tok == req.eos_id:
                reason = "eos"
            elif self.pos[slot] >= self.max_seq - 1:
                reason = "max_seq"
            if reason is not None:
                req.done_at = time.perf_counter()
                self.completed.append(req)
                self.slots[slot] = None
                self._m_completed.inc()
                self._m_evicted[reason].inc()
        self._set_gauges()
        return True

    def run(self, max_steps: int = 1000):
        while (self.queue or any(s is not None for s in self.slots)) \
                and self.decode_steps < max_steps:
            self.step()
        return self.completed
