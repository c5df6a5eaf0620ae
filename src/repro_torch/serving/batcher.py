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

Batched admission: the rows one admission takes that carry a prefix and
a suffix are grouped by suffix length S, and each group runs ONE extend
forward of its rows (a B-row ``Extender``: each row's prefix copied into
its own scratch row, one copy a cache leaf and prefix; positions [B, S]
per row; the rows' caches then copied into their slots), however many
snapshots the rows come from.  A forward of a large model reads every
weight however few rows it carries, so a group costs one weight pass
where its rows alone cost one each.  A group takes at most
``batch_rows`` rows: all of the pool's where rows do not interact, one
under capacity-bounded MoE (rows of one call compete for capacity that
one row alone never fills, so batching would drop pairs that are kept
today), and ``moe.SYNC_FREE_TOKENS`` tokens under dropless MoE (past it
the layer reads the largest expert's load back to the host); a larger
group splits, and a group of one row takes the B=1 path.  Rows without
a prefix (a B=1 prompt prefill) and rows whose prompt is the prefix (a
copy) keep their paths.

Spans (with ``bind_tracer``, on the tracer's "lm" track): ``lm-admit``
(the state copy, the prompt's forward and the first token's read; one a
batched forward, with its ``rows``), ``lm-decode`` (a decode step: the
forward and the logits' read) and ``lm-logprob`` (the host log-probs of
the tokens taken).  Counters (with ``bind_metrics``; ``LMCounters``):
``lm_tokens_forwarded_total{phase}`` (prompt: a prefill from an empty
row; suffix: an extend past a prefix; decode),
``lm_prefix_tokens_reused_total``, ``lm_attention_keys_total{phase}``
(the keys the forwarded tokens attend, causal),
``lm_logit_rows_total{phase}``, ``lm_admit_forwards_total`` and
``lm_admit_forward_rows_total`` (the forwards admissions ran, batched or
B=1, and the rows they carried) and ``moe_tokens_dropped_total`` (the
(token, expert) pairs the MoE layers dropped).  Every counter but the
admission forwards' two counts per row, batched or not.
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
        self._admit_forwards = reg.counter(
            "lm_admit_forwards_total",
            "forwards admissions ran (a prompt prefill, a B=1 or a "
            "batched extend)")
        self._admit_forward_rows = reg.counter(
            "lm_admit_forward_rows_total",
            "rows admissions ran through a forward")

    def forwarded(self, phase: str, start: int, n: int, rows: int = 1) -> None:
        """n tokens at positions start.. of a sequence, `rows` logits."""
        self._tokens[phase].inc(n)
        self._keys[phase].inc(n * start + n * (n + 1) // 2)
        self._rows[phase].inc(rows)

    def reused(self, n: int) -> None:
        self._reused.inc(n)

    def admitted(self, rows: int) -> None:
        """One admission forward of `rows` rows."""
        self._admit_forwards.inc()
        self._admit_forward_rows.inc(rows)

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


def copy_prefix(dst: dict, src: dict, n: int, at=slice(None)) -> None:
    """A sequence's first n positions from the caches `src` into rows `at`
    of the caches `dst` ([R, k, ...] views): every recurrent leaf whole,
    the attention K/V of positions 0..n-1 (unwrapped buffers).  `src`
    holds one sequence ([R, 1, ...]: every row gets it) or one a row."""
    for g, per_pos in src.items():
        for d, c in zip(dst[g], per_pos):
            for name, t in c.items():
                if name in lm.RECURRENT_LEAVES:
                    d[name][:, at] = t
                elif name in ("k", "v"):
                    d[name][:, at, :n] = t[:, :, :n]
                elif name != "pos":
                    raise NotImplementedError(
                        f"a prefix of cache leaf {name!r} is not copied")


def rows_of(caches: dict, a: int, b: int) -> dict:
    """Rows a..b-1 of stacked caches as [R, b-a, ...] views, the position
    scalars shared."""
    return {g: [{name: t if name == "pos" else t[:, a:b]
                 for name, t in c.items()} for c in per_pos]
            for g, per_pos in caches.items()}


def put_rows(caches: dict, slots: list, rows: dict, n: int) -> None:
    """The sequences in caches `rows` ([R, k, ...] views), their first n
    positions, into rows `slots` (k of them) of `caches` (``copy_prefix``:
    one copy a leaf, through a slice where the slots run on)."""
    at = slice(slots[0], slots[0] + len(slots))
    if slots != list(range(at.start, at.stop)):
        at = torch.as_tensor(slots, device=next(iter(
            caches.values()))[0]["pos"].device)
    copy_prefix(caches, rows, n, at)


def batch_rows(cfg, S: int, rows: int) -> int:
    """The most rows one extend forward of S-token suffixes takes out of
    `rows`: all where rows do not interact; one where a MoE layer bounds
    its capacity (rows of one call compete for it); under dropless MoE
    the rows whose S tokens a call holds without a host read
    (``moe.SYNC_FREE_TOKENS``)."""
    if not any(spec.mlp == "moe" for spec in cfg.layer_specs()):
        return rows
    if not cfg.moe_dropless:
        return 1
    return max(1, min(rows, M.SYNC_FREE_TOKENS // S))


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
    """Suffix forwards past prefix caches: the prefix copied into a
    scratch cache (``copy_prefix``), the suffix run through the model as
    an extend, the last position's logits; the scratch then holds the
    whole sequence (``copy_out`` moves it on).  With ``rows`` > 1 the
    scratch holds that many sequences and ``run_rows`` extends several
    at once, each from its own prefix and position.

    On a CUDA device each suffix length S in 1..`graph_lengths` replays a
    CUDA graph of the extend, captured at construction over the scratch
    and fixed token, position and logits buffers: the forward then costs
    its device time, not the host time of its thousands of op launches
    (a B=1 forward of granite-4.0-h-small launches about 8,000).  A
    B-row graph of S is captured at ``batch_rows(cfg, S, rows)`` rows;
    fewer rows fill the rest with dummies (token 0 at positions 0..S-1
    over whatever their scratch rows hold), whose outputs are dropped.
    Other lengths, and the CPU, run eagerly over the rows given.  The
    MoE drops count into `counters`' sink (captured as such)."""

    def __init__(self, cfg, params, max_len: int, impl: str, counters,
                 graph_lengths: int = 0, rows: int = 1):
        self.cfg, self.params, self.counters = cfg, params, counters
        self.max_len, self.rows = max_len, rows
        self.device = params["embed"]["tok"].device
        self.scratch = lm.init_caches(cfg, rows, max_len, self.device)
        self._step = steps.make_extend_step(cfg, impl=impl)
        self.graphs: dict = {}
        if graph_lengths and self.device.type == "cuda":
            pool = torch.cuda.graph_pool_handle()
            for S in range(1, graph_lengths + 1):
                if rows == 1 or batch_rows(cfg, S, rows) > 1:
                    self.graphs[S] = self._capture(S, pool)

    def _forward(self, tokens, positions, caches):
        with self.counters.counting():
            return self._step(self.params, tokens, caches, positions)[0]

    def _capture(self, S: int, pool) -> tuple:
        w = batch_rows(self.cfg, S, self.rows)
        tokens = torch.zeros((w, S), dtype=torch.int64, device=self.device)
        positions = torch.arange(S, dtype=torch.int32,
                                 device=self.device).repeat(w, 1)
        caches = rows_of(self.scratch, 0, w)
        graph, out = capture(lambda: self._forward(tokens, positions, caches),
                             self.device, pool)
        self.counters.sink.zero_()
        return graph, tokens, positions, out

    def run(self, prefix_caches: dict, n: int, suffix: np.ndarray):
        """[1, V] device logits of the sequence (the prefix's n tokens,
        then `suffix`) at its last position; scratch row 0 holds it."""
        return self.run_rows([(prefix_caches, n, np.asarray(suffix)[None])])

    def run_rows(self, runs: list):
        """[r, V] device logits of r sequences at their last positions:
        `runs` lists (prefix caches, n, suffixes [k, S]), every suffix of
        one length S, and the sequences (a prefix's n tokens, then a
        suffix) fill scratch rows 0..r-1 in that order, those of a run
        next to each other (``rows_of``)."""
        S = runs[0][2].shape[1]
        tok = np.concatenate([np.asarray(x[2], np.int64) for x in runs])
        pos = np.concatenate([np.broadcast_to(
            np.arange(n, n + S, dtype=np.int32), (len(x), S))
            for _, n, x in runs])
        a = 0
        for prefix, n, suffixes in runs:
            copy_prefix(rows_of(self.scratch, a, a + len(suffixes)), prefix,
                        n)
            a += len(suffixes)
        r = len(tok)
        got = self.graphs.get(S)
        if got is None:
            return self._forward(torch.as_tensor(tok, device=self.device),
                                 torch.as_tensor(pos, device=self.device),
                                 rows_of(self.scratch, 0, r))
        graph, tokens, positions, out = got
        w = tokens.shape[0]
        if r < w:            # dummy rows: token 0 at positions 0..S-1
            tok = np.concatenate([tok, np.zeros((w - r, S), np.int64)])
            pos = np.concatenate([pos, np.broadcast_to(
                np.arange(S, dtype=np.int32), (w - r, S))])
        tokens.copy_(torch.as_tensor(tok))
        positions.copy_(torch.as_tensor(pos))
        graph.replay()
        return out[:r]

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
        # the extender has them), a group of rows in a pool-wide scratch
        # (`group_extender`, its graphs captured here at the given
        # extender's suffix lengths), then moves into the slots' rows
        self.extender = extender
        self._impl = impl
        self.group_extender = None
        lengths = max(extender.graphs, default=0) if extender else 0
        if cuda_graphs and lengths and batch_rows(cfg, 1, pool_size) > 1:
            self.group_extender = Extender(cfg, params, extender.max_len,
                                           impl, self.counters, lengths,
                                           rows=pool_size)
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
        take = [(slot, self.queue.pop(0)) for slot in range(self.B)
                if self.slots[slot] is None and self.queue]
        groups: dict = {}        # suffix length -> [(slot, req, n)]
        for slot, req in take:
            S = self._suffix(req)
            if S:
                groups.setdefault(S, []).append(
                    (slot, req, len(req.prefix.tokens)))
            else:
                self._admit_one(slot, req)
        for S, rows in groups.items():
            w = batch_rows(self.cfg, S, self.B)
            for i in range(0, len(rows), w):
                self._admit_rows(S, rows[i:i + w])
        self._set_gauges()

    def _suffix(self, req: Request):
        """The number of the request's prompt tokens past its prefix, or
        None without a prefix."""
        if req.prefix is None:
            return None
        n = len(req.prefix.tokens)
        prompt = np.asarray(req.prompt, np.int64)
        if n > len(prompt) or not np.array_equal(prompt[:n],
                                                 req.prefix.tokens):
            raise ValueError(f"request {req.uid}: its prompt does not start "
                             f"with its prefix's {n} tokens")
        return len(prompt) - n

    def _take(self, slot: int, req: Request, tok: int) -> None:
        self.slots[slot] = req
        self.pos[slot] = len(req.prompt)
        self.cur_tok[slot, 0] = tok
        req.tokens.append(tok)
        self._m_admitted.inc()

    def _admit_one(self, slot: int, req: Request) -> None:
        """A prompt without a prefix (a B=1 prefill) or equal to it (a
        copy)."""
        with self.trace.span("lm-admit", cat="lm", tid=self._tid, slot=slot):
            logits = self._prefill_row(slot, req)
            tok = int(np.argmax(logits)) if isinstance(
                logits, np.ndarray) else int(torch.argmax(logits[0]))
        self.counters.fold()
        self._take(slot, req, tok)
        if self.record_logprobs:
            with self.trace.span("lm-logprob", cat="lm", tid=self._tid,
                                 rows=1):
                row = logits if isinstance(logits, np.ndarray) \
                    else logits[0].cpu().numpy()
                req.logprobs.append(_logprob(row, tok))

    def _extender(self, rows: int) -> Extender:
        """The B=1 extender for one row, else the pool-wide one; made at
        the first such group where none is given."""
        if rows == 1:
            if self.extender is None:
                self.extender = Extender(self.cfg, self.params, self.max_seq,
                                         self._impl, self.counters)
            return self.extender
        if self.group_extender is None:
            self.group_extender = Extender(
                self.cfg, self.params, self.extender.max_len
                if self.extender else self.max_seq, self._impl,
                self.counters, rows=self.B)
        return self.group_extender

    def _admit_rows(self, S: int, rows: list) -> None:
        """Rows (slot, request, prefix length) whose prompts run S tokens
        past their prefixes: one extend forward of them all (B=1 for one
        row), a copy a cache leaf and prefix into the scratch and out to
        the slots."""
        order: dict = {}        # a prefix's caches -> its rows, in order
        for row in rows:
            order.setdefault(id(row[1].prefix.caches), []).append(row)
        rows = [row for run in order.values() for row in run]
        c, ext = self.counters, self._extender(len(rows))
        with self.trace.span("lm-admit", cat="lm", tid=self._tid,
                             rows=len(rows)):
            runs = [(run[0][1].prefix.caches, run[0][2], np.stack([
                np.asarray(req.prompt[n:], np.int64) for _, req, n in run]))
                for run in order.values()]
            logits = ext.run_rows(runs)
            a = 0
            for run in order.values():
                put_rows(self.caches, [slot for slot, _, _ in run],
                         rows_of(ext.scratch, a, a + len(run)), run[0][2] + S)
                a += len(run)
            nxt = torch.argmax(logits, -1).cpu().numpy()
        c.fold()
        if ext.counters is not c:
            ext.counters.fold()
        c.admitted(len(rows))
        for (slot, req, n), tok in zip(rows, nxt):
            c.reused(n)
            c.forwarded("suffix", n, S)
            self._take(slot, req, int(tok))
        if self.record_logprobs:
            with self.trace.span("lm-logprob", cat="lm", tid=self._tid,
                                 rows=len(rows)):
                host = logits.cpu().numpy()
                for (_, req, _), tok, row in zip(rows, nxt, host):
                    req.logprobs.append(_logprob(row, int(tok)))

    def _prefill_row(self, slot: int, req: Request):
        """A prompt without a suffix past its prefix into the slot's cache
        row: a prefill ([1, V] device logits of its last position), or a
        copy of its prefix (the prefix's host row)."""
        row = _slot_view(self.caches, slot)
        pre, c = req.prefix, self.counters
        if pre is not None:
            c.reused(len(pre.tokens))
            copy_prefix(row, pre.caches, len(pre.tokens))
            return pre.logits
        prompt = np.asarray(req.prompt, np.int64)
        _clear_recurrent(row)
        with c.counting():
            t = torch.as_tensor(prompt, device=self.device)[None]
            logits, _ = self._prefill_one(self.params, t, row)
        c.forwarded("prompt", 0, len(prompt))
        c.admitted(1)
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
