"""LM-decode-as-tree-search on torch: the environment and simulation
backend that plan over next-token actions with a language model (the
port of repro.sim.lm).

  * LMTreeEnv — states are token sequences (stored in the StateTable);
    actions are the top-F tokens the LM proposes at each node, from one
    forward (a prefill through the flash kernel on the card); the
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

States are float32 ``[len, tokens...]`` of ``max_len + 1`` words, as in
the JAX package (whose cap is ``MAXLEN``, the default); token ids are
exact in float32 below 2^24, which covers every vocabulary of the repo's
configs (llama3.2-1b: 128,256).  ``capacity()`` sizes ``max_len`` for a
serving stream: the longest prompt, the moves planned, the tree depth
and the horizon.  A root is a prompt registered under a request's seed
(``register``); an unregistered seed starts from the JAX package's
one-token root.

Root snapshots (``snapshots=True``; a pool over the env drives them
through ``root_changed``).  Every node of a search extends its root's
prompt, so the prompt runs through the model once, at admission, into a
snapshot of every layer's state (B=1 caches: the recurrent layers' conv
tails and SSD states, the attention layers' K/V) beside the last
position's logits.  Each committed move advances the snapshot by its
token.  An expansion forwards only the state's tokens past the longest
live snapshot that holds a prefix of it, from a copy of that snapshot;
a continuation's admission copies the snapshot into its pool row and
prefills only the suffix.  The top tokens of each state expanded are
kept with its search's snapshot, so every expansion of a node reads one
forward.  A snapshot is freed when its search ends: with G slots at
most G snapshots are live (G+1 while a commit copies a shared one).
Global GQA attention only: a windowed, latent (MLA), prefix or encoder
model refuses snapshots.

Spans (``bind_tracer``, on the tracer's "lm" track): ``lm-snapshot``
(a prompt's prefill, or a commit's one-token advance) and ``lm-expand``
(the forward of a state not yet expanded and its host top-F); the
backend's batcher adds ``lm-admit``, ``lm-decode`` and ``lm-logprob``.
Counters (``bind_metrics``): serving.batcher's ``LMCounters``.

On the card, ``cuda_graphs=n`` replays CUDA graphs of the suffix
forwards of 1..n tokens (serving.batcher's ``Extender``), of the
backend's batched admissions (one forward of a wave's rows of one
suffix length, at the pool's width) and of its decode step, captured at
construction: a B=1 forward of a large model is otherwise bound by the
host's op launches.

Determinism: the batcher's decode is greedy and its pool schedule is a
pure function of the submitted request stream, so evaluate() is
reproducible for a given states batch on one device.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.models import lm, steps
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.serving.batcher import (
    ContinuousBatcher, Extender, LMCounters, PrefixState, Request,
)

__all__ = ["MAXLEN", "LMTreeEnv", "LMContinuationBackend"]

MAXLEN = 48          # the JAX package's sequence cap: the default max_len


def capacity(prompt: int, moves: int, depth: int, horizon: int) -> int:
    """max_len for roots of up to `prompt` tokens, `moves` committed
    tokens, trees `depth` deep and continuations of `horizon` tokens."""
    return prompt + moves + depth + horizon


class _Snapshot(PrefixState):
    """A live root snapshot: its searches count and the top tokens of
    every state of theirs expanded."""

    def __init__(self, tokens, caches, logits):
        super().__init__(tokens, caches, logits)
        self.users = 1
        self.tops: dict = {}


class LMTreeEnv:
    """Token-sequence environment over an LM whose parameters live on
    the device the forwards run on.  ``impl`` is the prefill attention:
    "flash" (the kernel on the card, its plain version on the CPU) or
    "naive"."""

    state_dtype = np.float32

    def __init__(self, cfg, params, fanout: int = 6, horizon: int = 5,
                 impl: str = "flash", max_len: int = MAXLEN,
                 snapshots: bool = False, cuda_graphs: int = 0):
        self.cfg, self.params = cfg, params
        self.F, self.horizon, self.impl = fanout, horizon, impl
        self.max_len = int(max_len)
        self.device = params["embed"]["tok"].device
        self.state_shape = (self.max_len + 1,)   # [len, tokens...]
        self.max_actions = fanout
        self.prompts: dict = {}
        self.snapshots = bool(snapshots)
        if self.snapshots:
            _check_snapshots(cfg)
        self._live: dict = {}       # tokens bytes -> _Snapshot
        self._prefill = steps.make_prefill_step(cfg, impl=impl)
        self.counters = LMCounters(self.device)
        self.cuda_graphs = int(cuda_graphs)
        # the suffix forwards past a snapshot (expansions, advances, and
        # the backend's admissions): B=1 scratch, CUDA graphs of suffixes
        # of 1..cuda_graphs tokens on the card
        self.extender = Extender(cfg, params, self.max_len, impl,
                                 self.counters, self.cuda_graphs) \
            if self.snapshots else None
        self.bind_tracer(None)

    # ---- telemetry ----
    def bind_tracer(self, tracer) -> None:
        self.trace = NULL_TRACER if tracer is None else tracer
        self._tid = self.trace.track("lm") if tracer is not None else 0

    def bind_metrics(self, metrics) -> None:
        self.counters.bind(metrics)

    # ---- roots ----
    def register(self, seed: int, prompt) -> None:
        """`prompt` (token ids) becomes the root of requests of `seed`."""
        prompt = np.asarray(prompt, np.int64)
        if not 1 <= len(prompt) <= self.max_len - self.horizon:
            raise ValueError(f"a prompt of {len(prompt)} tokens does not fit "
                             f"max_len={self.max_len} less the horizon")
        self.prompts[int(seed)] = prompt

    def initial_state(self, seed: int) -> np.ndarray:
        s = np.zeros(self.max_len + 1, np.float32)
        prompt = self.prompts.get(int(seed))
        if prompt is None:
            s[0] = 1
            s[1] = 1 + seed % 7
        else:
            s[0] = len(prompt)
            s[1:1 + len(prompt)] = prompt
        return s

    def tokens(self, state: np.ndarray) -> np.ndarray:
        n = int(state[0])
        return np.asarray(state[1 : 1 + n], np.int64)

    # ---- expansion ----
    def logits(self, state: np.ndarray) -> np.ndarray:
        """Host float32 logits of the state's last position: from the
        longest live snapshot holding a prefix of it (the suffix forwarded
        from a copy of the snapshot), else one forward of the whole
        sequence."""
        toks = self.tokens(state)
        snap = self.snapshot_of(toks)
        if snap is not None and len(snap.tokens) == len(toks):
            return snap.logits
        c = self.counters
        with c.counting():
            if snap is None:
                t = torch.as_tensor(toks, device=self.device)[None]
                x, _ = lm.hidden_states(self.cfg, self.params, t,
                                        impl=self.impl)
                # the last position's logits (the JAX package unembeds all
                # and slices); host float32
                out = L.unembed(self.cfg, self.params["embed"],
                                x[0, -1]).cpu().numpy()
                c.forwarded("suffix", 0, len(toks))
            else:
                n = len(snap.tokens)
                out = self.extender.run(snap.caches, n,
                                        toks[n:])[0].cpu().numpy()
                c.reused(n)
                c.forwarded("suffix", n, len(toks) - n)
        c.fold()
        return out

    def top_actions(self, state: np.ndarray) -> np.ndarray:
        # numpy's argsort of host float32, so ties order as in JAX; a
        # search's states keep theirs in its snapshot
        snap = self.snapshot_of(self.tokens(state))
        key = np.asarray(state, np.float32).tobytes()
        if snap is not None and key in snap.tops:
            return snap.tops[key]
        with self.trace.span("lm-expand", cat="lm", tid=self._tid,
                             tokens=int(state[0])):
            top = np.argsort(-self.logits(state))[: self.F]
        if snap is not None:
            snap.tops[key] = top
        return top

    def num_actions(self, state: np.ndarray) -> int:
        return 0 if int(state[0]) >= self.max_len - self.horizon else self.F

    def step(self, state: np.ndarray, a: int):
        tok = int(self.top_actions(state)[a])
        s = state.copy()
        n = int(s[0])
        s[1 + n] = tok
        s[0] = n + 1
        return s, 0.0, int(s[0]) >= self.max_len - self.horizon

    # ---- root snapshots ----
    def snapshot_of(self, toks: np.ndarray):
        """The longest live snapshot whose tokens begin `toks`, or None."""
        best = None
        for snap in self._live.values():
            n = len(snap.tokens)
            if n <= len(toks) and (best is None or n > len(best.tokens)) \
                    and np.array_equal(toks[:n], snap.tokens):
                best = snap
        return best

    def root_changed(self, old, new) -> None:
        """A pool's root moved: a search was admitted at `new` (old
        None), committed a move from `old` to `new`, or ended at `old`
        (new None)."""
        if not self.snapshots:
            return
        snap = None
        if old is not None:
            snap = self._live[self.tokens(old).tobytes()]
            snap.users -= 1
            if snap.users == 0:
                del self._live[snap.tokens.tobytes()]
        if new is None:
            return
        toks = self.tokens(new)
        have = self._live.get(toks.tobytes())
        if have is not None:
            have.users += 1
        elif snap is not None and len(toks) == len(snap.tokens) + 1:
            if snap.users:            # another search holds it: a copy
                snap = _Snapshot(snap.tokens, _clone(snap.caches),
                                 snap.logits)
                snap.tops = dict(snap.tops)
            self._advance(snap, toks)
        else:
            self._open(toks)

    def _open(self, toks: np.ndarray) -> None:
        c = self.counters
        caches = lm.init_caches(self.cfg, 1, self.max_len, self.device)
        with self.trace.span("lm-snapshot", cat="lm", tid=self._tid,
                             tokens=len(toks)), c.counting():
            t = torch.as_tensor(toks, device=self.device)[None]
            logits = self._prefill(self.params, t, caches)[0][0].cpu().numpy()
            c.forwarded("prompt", 0, len(toks))
        c.fold()
        self._live[toks.tobytes()] = _Snapshot(toks, caches, logits)

    def _advance(self, snap: _Snapshot, toks: np.ndarray) -> None:
        """The snapshot extended by the last of `toks` (one token) in
        place, and live under its new tokens."""
        c, n = self.counters, len(snap.tokens)
        with self.trace.span("lm-snapshot", cat="lm", tid=self._tid,
                             tokens=1):
            snap.logits = self.extender.run(snap.caches, n,
                                            toks[n:])[0].cpu().numpy()
            self.extender.copy_out(snap.caches, len(toks))
            c.reused(n)
            c.forwarded("suffix", n, 1)
        c.fold()
        snap.tokens, snap.users = toks, 1
        self._live[toks.tobytes()] = snap

    @property
    def live_snapshots(self) -> int:
        return len(self._live)


def _clone(caches: dict) -> dict:
    return {g: [{k: t.clone() for k, t in c.items()} for c in per_pos]
            for g, per_pos in caches.items()}


def _check_snapshots(cfg) -> None:
    specs = cfg.layer_specs()
    if (cfg.attn_impl != "gqa" or cfg.vlm_patches or cfg.encoder is not None
            or any(s.kind == "rglru" or (s.kind == "attn" and s.window)
                   for s in specs)):
        raise ValueError(f"{cfg.name}: root snapshots extend a cache, which "
                         f"global GQA attention and SSD layers do; this "
                         f"model has windowed, latent, recurrent-gemma, "
                         f"prefix or encoder layers")


class LMContinuationBackend:
    """Simulation = greedy LM continuation scored by mean log-prob,
    decoded for ALL rows concurrently through one ContinuousBatcher pool.

    ``pool_size`` is the LM serving microbatch: rows beyond it queue and
    admit as earlier continuations finish, so a batch of B rows costs
    ceil(B / pool_size) waves of `horizon` decode steps.  Its prefills
    use the env's attention ``impl``; a row whose state extends a live
    root snapshot is admitted from it, a wave's such rows one forward a
    suffix length.  Equal rows of one batch (a microbatch's padding) are
    decoded once."""

    def __init__(self, env: LMTreeEnv, pool_size: int = 8, metrics=None):
        self.env = env
        self._uid = itertools.count()
        self.batcher = ContinuousBatcher(
            env.cfg, env.params, pool_size=pool_size,
            max_seq=env.max_len + env.horizon + 2, impl=env.impl,
            record_logprobs=True, metrics=metrics, extender=env.extender,
            cuda_graphs=env.cuda_graphs > 0)

    def bind_metrics(self, metrics) -> None:
        self.batcher.bind_metrics(metrics)

    def bind_tracer(self, tracer) -> None:
        self.batcher.bind_tracer(tracer)

    def evaluate(self, states: np.ndarray):
        first: dict = {}            # row bytes -> the row's first index
        keys = [np.asarray(s).tobytes() for s in states]
        for i, k in enumerate(keys):
            first.setdefault(k, i)
        reqs = []
        for i in first.values():
            toks = self.env.tokens(states[i])
            reqs.append(Request(
                uid=next(self._uid), prompt=toks.astype(np.int32),
                max_new_tokens=self.env.horizon,
                prefix=self.env.snapshot_of(toks)))
        self.batcher.completed = []
        for r in reqs:
            self.batcher.submit(r)
        done = self.batcher.run(
            max_steps=self.batcher.decode_steps
            + (len(reqs) + 2) * self.env.horizon)
        if len(done) != len(reqs):
            raise RuntimeError(
                f"LM continuation pool drained {len(done)}/{len(reqs)} rows")
        by_uid = {r.uid: r for r in done}
        value = {k: np.float32(sum(by_uid[r.uid].logprobs) / self.env.horizon)
                 for k, r in zip(first, reqs)}
        return np.asarray([value[k] for k in keys], np.float32), None
