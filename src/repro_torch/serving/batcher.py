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

A request may carry a ``prefix``: a cache of one sequence (a
``PrefixState``: B=1 caches, the tokens they hold, the last position's
logits) that its prompt starts with.  Its admission copies both kinds of
state into the row in place (the recurrent leaves whole, the attention
K/V of the prefix's positions) and runs only the prompt's remaining
tokens through the model (an extend), or none when the prompt is the
prefix itself.

Spans (with ``bind_tracer``, on the tracer's "lm" track): ``lm-admit``
(the state copy, the prompt's forward and the first token's read),
``lm-decode`` (a decode step: the forward and the logits' read) and
``lm-logprob`` (the host log-probs of the tokens taken).  Counters (with
``bind_metrics``; ``LMCounters``): ``lm_tokens_forwarded_total{phase}``
(prompt: a prefill from an empty row; suffix: an extend past a prefix;
decode), ``lm_prefix_tokens_reused_total``, ``lm_attention_keys_total
{phase}`` (the keys the forwarded tokens attend, causal),
``lm_logit_rows_total{phase}`` and ``moe_tokens_dropped_total`` (the
(token, expert) pairs the MoE layers dropped).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.models import lm, steps
from repro_torch.models import moe as M
from repro_torch.obs.metrics import NULL_REGISTRY
from repro_torch.obs.trace import NULL_TRACER

PHASES = ("prompt", "suffix", "decode")


@dataclasses.dataclass
class PrefixState:
    """One sequence's cache: B=1 caches holding `tokens`, and the host f32
    logits of its last position."""
    tokens: np.ndarray
    caches: dict
    logits: np.ndarray


class LMCounters:
    """The LM path's forward counters and its MoE drop count, in a
    registry.  `dropped` is the host total of the pairs dropped so far,
    kept whether a registry is bound or not."""

    def __init__(self, device, metrics=None):
        self.sink = torch.zeros((), dtype=torch.int64, device=device)
        self.dropped = 0
        self.bind(metrics)

    def bind(self, metrics) -> None:
        reg = NULL_REGISTRY if metrics is None else metrics
        self._tokens = {ph: reg.counter(
            "lm_tokens_forwarded_total", "tokens run through the LM",
            phase=ph) for ph in PHASES}
        self._keys = {ph: reg.counter(
            "lm_attention_keys_total",
            "keys the forwarded tokens attend (causal)", phase=ph)
            for ph in PHASES}
        self._rows = {ph: reg.counter(
            "lm_logit_rows_total", "positions unembedded to logits",
            phase=ph) for ph in PHASES}
        self._reused = reg.counter(
            "lm_prefix_tokens_reused_total",
            "prefix tokens a forward started past (held in a cache)")
        self._drops = reg.counter(
            "moe_tokens_dropped_total",
            "(token, expert) pairs the MoE layers dropped")

    def forwarded(self, phase: str, start: int, n: int, rows: int = 1) -> None:
        """n tokens at positions start.. of a sequence, `rows` logits."""
        self._tokens[phase].inc(n)
        self._keys[phase].inc(n * start + n * (n + 1) // 2)
        self._rows[phase].inc(rows)

    def reused(self, n: int) -> None:
        self._reused.inc(n)

    def counting(self):
        """The context the LM's forwards run in: MoE drops into `sink`."""
        return M.counting_drops(self.sink)

    def fold(self) -> None:
        """The sink's drops into the counter (after a host read)."""
        n = int(self.sink)
        if n:
            self.sink.zero_()
            self.dropped += n
            self._drops.inc(n)


def copy_prefix(row: dict, prefix: dict, n: int) -> None:
    """A sequence's first n positions from B=1 caches `prefix` into the
    caches `row` ([R, 1, ...] views): every recurrent leaf whole, the
    attention K/V of positions 0..n-1 (unwrapped buffers)."""
    for g, per_pos in prefix.items():
        for dst, src in zip(row[g], per_pos):
            for name, t in src.items():
                if name in lm.RECURRENT_LEAVES:
                    dst[name].copy_(t)
                elif name in ("k", "v"):
                    dst[name][:, :, :n].copy_(t[:, :, :n])
                elif name != "pos":
                    raise NotImplementedError(
                        f"a prefix of cache leaf {name!r} is not copied")


def capture(fn, device, pool=None) -> tuple:
    """(graph, output) of fn() captured as a CUDA graph, after one call on
    a side stream that makes its workspaces and lazy state outside it."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool):
        out = fn()
    return graph, out


class Extender:
    """Suffix forwards of one sequence (B=1) past a prefix cache: the
    prefix copied into a scratch cache (``copy_prefix``), the suffix run
    through the model as an extend, the last position's logits; the
    scratch then holds the whole sequence (``copy_out`` moves it on).

    On a CUDA device each suffix length in 1..`graph_lengths` replays a
    CUDA graph of the extend, captured at construction over the scratch
    and fixed token, position and logits buffers: the forward then costs
    its device time, not the host time of its thousands of op launches
    (a B=1 forward of granite-4.0-h-small launches about 8,000).  Other
    lengths, and the CPU, run eagerly.  The MoE drops count into
    `counters`' sink (captured as such)."""

    def __init__(self, cfg, params, max_len: int, impl: str, counters,
                 graph_lengths: int = 0):
        self.params, self.counters = params, counters
        self.device = params["embed"]["tok"].device
        self.scratch = lm.init_caches(cfg, 1, max_len, self.device)
        self._step = steps.make_extend_step(cfg, impl=impl)
        self.graphs: dict = {}
        if graph_lengths and self.device.type == "cuda":
            pool = torch.cuda.graph_pool_handle()
            for S in range(1, graph_lengths + 1):
                self.graphs[S] = self._capture(S, pool)

    def _forward(self, tokens, positions):
        with self.counters.counting():
            return self._step(self.params, tokens, self.scratch, positions)[0]

    def _capture(self, S: int, pool) -> tuple:
        tokens = torch.zeros((1, S), dtype=torch.int64, device=self.device)
        positions = torch.arange(S, dtype=torch.int32, device=self.device)
        graph, out = capture(lambda: self._forward(tokens, positions),
                             self.device, pool)
        self.counters.sink.zero_()
        return graph, tokens, positions, out

    def run(self, prefix_caches: dict, n: int, suffix: np.ndarray):
        """[1, V] device logits of the sequence (the prefix's n tokens,
        then `suffix`) at its last position; the scratch holds it."""
        copy_prefix(self.scratch, prefix_caches, n)
        S = len(suffix)
        t = torch.as_tensor(np.asarray(suffix, np.int64))[None]
        pos = torch.arange(n, n + S, dtype=torch.int32)
        got = self.graphs.get(S)
        if got is None:
            return self._forward(t.to(self.device), pos.to(self.device))
        graph, tokens, positions, out = got
        tokens.copy_(t)
        positions.copy_(pos)
        graph.replay()
        return out

    def copy_out(self, caches: dict, n: int) -> None:
        """The scratch's first n positions into `caches` (B=1 caches or a
        pool row)."""
        copy_prefix(caches, self.scratch, n)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # [S] int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    prefix: Optional[PrefixState] = None   # a cache the prompt starts with
    # filled by the batcher:
    tokens: list = dataclasses.field(default_factory=list)
    logprobs: list = dataclasses.field(default_factory=list)
    submitted_at: float = 0.0
    done_at: float = 0.0


def _logprob(logits_row: np.ndarray, tok: int) -> float:
    """Log-probability of one token under a logits row (host-side): the
    max-shifted log-sum-exp, its sum in float64 (the JAX package takes
    numpy's logaddexp.reduce, one element at a time: 5.9 ms over a
    128,256-token row, against about 0.2 ms)."""
    l = np.asarray(logits_row, np.float32)
    m = l.max()
    return float(l[tok] - m - np.log(np.exp(l - m).sum(dtype=np.float64)))


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
                 record_logprobs: bool = False, metrics=None,
                 extender: Optional[Extender] = None,
                 cuda_graphs: bool = False):
        self.cfg, self.params = cfg, params
        self.device = params["embed"]["tok"].device
        self.B, self.max_seq = pool_size, max_seq
        self.max_pending = max_pending
        self.record_logprobs = record_logprobs
        self.caches = lm.init_caches(cfg, pool_size, max_seq, self.device)
        self._decode = steps.make_decode_step(cfg, impl=impl)
        self._prefill_one = steps.make_prefill_step(cfg, impl=impl)
        self.counters = LMCounters(self.device)
        # a prefix's suffix runs in B=1 scratch (its CUDA graphs, where
        # the extender has them), then moves into the slot's row; made at
        # the first such request where none is given
        self.extender = extender
        self._impl = impl
        self.bind_tracer(None)
        self.slots: list[Optional[Request]] = [None] * pool_size
        self.pos = np.zeros(pool_size, np.int64)       # next position per slot
        self.cur_tok = np.zeros((pool_size, 1), np.int32)
        self.queue: list[Request] = []
        self.completed: list[Request] = []
        self.decode_steps = 0
        self.bind_metrics(metrics)
        self._graph = None
        if cuda_graphs and self.device.type == "cuda":
            self._graph = self._capture_decode()

    def _capture_decode(self) -> tuple:
        """A CUDA graph of the decode step over the pool's caches and
        fixed token, position and logits buffers (every row, idle rows
        included, as the eager step)."""
        tok = torch.zeros((self.B, 1), dtype=torch.int64, device=self.device)
        posv = torch.zeros(self.B, dtype=torch.int32, device=self.device)

        def body():
            with self.counters.counting():
                return self._decode(self.params, self.caches, tok, posv)[0]
        graph, out = capture(body, self.device)
        self.counters.sink.zero_()
        return graph, tok, posv, out

    def bind_tracer(self, tracer) -> None:
        self.trace = NULL_TRACER if tracer is None else tracer
        self._tid = self.trace.track("lm") if tracer is not None else 0

    def bind_metrics(self, metrics) -> None:
        self.counters.bind(metrics)
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
            with self.trace.span("lm-admit", cat="lm", tid=self._tid,
                                 slot=slot):
                logits = self._prefill_row(slot, req)
                tok = int(np.argmax(logits)) if isinstance(
                    logits, np.ndarray) else int(torch.argmax(logits[0]))
            self.counters.fold()
            if self.extender is not None:
                self.extender.counters.fold()
            self.slots[slot] = req
            self.pos[slot] = len(req.prompt)
            self.cur_tok[slot, 0] = tok
            req.tokens.append(tok)
            if self.record_logprobs:
                with self.trace.span("lm-logprob", cat="lm", tid=self._tid,
                                     rows=1):
                    row = logits if isinstance(logits, np.ndarray) \
                        else logits[0].cpu().numpy()
                    req.logprobs.append(_logprob(row, tok))
            self._m_admitted.inc()
        self._set_gauges()

    def _prefill_row(self, slot: int, req: Request):
        """The request's prompt into the slot's cache row: the last
        position's logits ([1, V] on the device, or the prefix's host row
        when the prompt is the prefix)."""
        prompt = np.asarray(req.prompt, np.int64)
        row = _slot_view(self.caches, slot)
        pre, c = req.prefix, self.counters
        n = 0 if pre is None else len(pre.tokens)
        if pre is not None and (n > len(prompt)
                                or not np.array_equal(prompt[:n], pre.tokens)):
            raise ValueError(f"request {req.uid}: its prompt does not start "
                             f"with its prefix's {n} tokens")
        with c.counting():
            if pre is None:
                _clear_recurrent(row)
                t = torch.as_tensor(prompt, device=self.device)[None]
                logits, _ = self._prefill_one(self.params, t, row)
                c.forwarded("prompt", 0, len(prompt))
            else:
                c.reused(n)
                if n == len(prompt):
                    copy_prefix(row, pre.caches, n)
                    return pre.logits
                if self.extender is None:
                    self.extender = Extender(self.cfg, self.params,
                                             self.max_seq, self._impl, c)
                logits = self.extender.run(pre.caches, n, prompt[n:])
                self.extender.copy_out(row, len(prompt))
                c.forwarded("suffix", n, len(prompt) - n)
        return logits

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
        c = self.counters
        with self.trace.span("lm-decode", cat="lm", tid=self._tid,
                             rows=int(occupied.sum())), c.counting():
            if self._graph is None:
                logits, self.caches = self._decode(self.params, self.caches,
                                                   tok, posv)
            else:
                graph, g_tok, g_pos, logits = self._graph
                g_tok.copy_(tok)
                g_pos.copy_(posv)
                graph.replay()
            host_logits = logits.cpu().numpy() if self.record_logprobs \
                else None
            nxt = torch.argmax(logits, -1).to(torch.int32).cpu().numpy()
        c.fold()
        for slot in np.flatnonzero(occupied):
            c.forwarded("decode", int(self.pos[slot]), 1)
        self.decode_steps += 1
        if host_logits is not None:
            with self.trace.span("lm-logprob", cat="lm", tid=self._tid,
                                 rows=int(occupied.sum())):
                for slot, req in enumerate(self.slots):
                    if req is not None:
                        req.logprobs.append(
                            _logprob(host_logits[slot], int(nxt[slot])))
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            tok = int(nxt[slot])
            req.tokens.append(tok)
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
