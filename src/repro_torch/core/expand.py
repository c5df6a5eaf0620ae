"""Host-expansion engine (paper Alg. 2 step 3, batched across the arena).

The CPU half of Expansion — ST reads, 1-step env transitions, ST writes:

  mode="loop"    — the per-worker loop over ``env.step`` (reference
                   semantics).
  mode="vector"  — every pending expansion of every slot is flattened into
                   ONE [B] batch: one ``VectorEnv.step_batch`` call, one
                   ``num_actions_batch`` call, one duplicate-checked ST
                   write per slot (state_table.write's distinct-id assert
                   is the paper's §III-B invariant, now checked per batch).
                   Requires the env to implement envs.vector.VectorEnv.
  mode="pool"    — the same flattened batch, served by a process pool of
                   scalar-env workers (envs.vector.PoolVectorEnv) — the
                   paper's multi-worker CPU side, for envs without a
                   vectorized form.
  mode="auto"    — "vector" when the env supports it, else "loop".

All modes are bit-identical: the flattening preserves the loop's
(slot, worker, action) visit order, and step_batch implementations match
scalar ``step`` element for element.

In pool mode step and successor action counts go to the workers in ONE
round trip per superstep (PoolVectorEnv.step_and_count_batch), so the
states are pickled once, not twice.

Asynchronous expansion (the overlap serving mode's host half):
``expand_submit`` does the flattening and, in pool mode, posts the env
batch to the worker processes WITHOUT waiting, returning a
PendingExpansion; ``expand_collect`` blocks on the posted chunks and
finishes the ST scatter.  ``expand`` is ``collect(submit())``, so the
split is bit-identical to the blocking call.  Between submit and collect
the workers step their chunks while the caller's thread runs another
gang's Simulation / finalize / BackUp (service.pool's gang pipeline).
Modes without an async env leg (loop, vector, or a pooled batch small
enough to step inline) compute at submit time, and collect unwraps.

TreeParallelMCTS feeds it one slot, service.pool.ArenaPool every active
slot of a superstep (and a SchedulerCore shares ONE engine across all its
pools); each call records its spans and the expansion metrics.  This
module is the port's copy of repro.core.expand (pure numpy).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.core import fixedpoint as fx
from repro_torch.core.state_table import StateTable
from repro_torch.core.tree import NULL
from repro_torch.envs.vector import (
    PoolVectorEnv, has_async_step, has_fused_step, has_vector_env,
)
from repro_torch.obs.metrics import NULL_REGISTRY
from repro_torch.obs.trace import NULL_TRACER

EXPANSION_MODES = ("loop", "vector", "pool", "auto")


@dataclasses.dataclass
class HostExpansion:
    """Result of the host half of Expansion for one tree's superstep:
    1-step env transitions for every expanding worker, ST writes done,
    metadata queued for finalize, and the simulation batch rows."""

    sim_nodes: Any       # [p] i32 node each simulation runs from
    sim_states: Any      # [p, ...] states for SimulationBackend.evaluate
    fin_nodes: list      # inserted node ids (ragged)
    fin_na: list         # their legal-action counts
    fin_term: list       # their terminal flags
    prior_parents: list  # parents receiving prior rows (expand-all mode)
    prior_workers: list  # worker index whose sim state produced each prior

    def padded_finalize_args(self, K: int, p: int, Fp: int, priors) -> tuple:
        """Fixed-shape NULL-padded finalize arguments: every slot must
        contribute identical shapes to the arena finalize (the G=1 driver
        uses the same convention with a leading [1] axis)."""
        nodes = np.full(K, NULL, np.int32)
        na = np.zeros(K, np.int32)
        term = np.zeros(K, np.int32)
        k = len(self.fin_nodes)
        nodes[:k] = self.fin_nodes
        na[:k] = self.fin_na
        term[:k] = self.fin_term
        pp = np.full(p, NULL, np.int32)
        pf = np.zeros((p, Fp), np.int32)
        if priors is not None and self.prior_workers:
            pp[: len(self.prior_parents)] = self.prior_parents
            pf[: len(self.prior_workers)] = encode_prior_rows(
                priors, self.prior_workers, Fp)
        return nodes, na, term, pp, pf


def encode_prior_rows(priors, prior_workers, Fp: int) -> np.ndarray:
    """Select the expand-all workers' prior rows and pad to Fp lanes
    (Qm.16).  Priors are produced for the leaf states that expanded-all —
    sim node == leaf for those workers."""
    pr = np.asarray(priors)[prior_workers]
    padded = np.zeros((len(prior_workers), Fp), np.float32)
    padded[:, : pr.shape[1]] = pr
    return np.asarray(fx.encode(padded), np.int32)


def host_expand_phase(env, st: StateTable, sel: dict,
                      new_nodes: np.ndarray) -> HostExpansion:
    """ST reads, 1-step env transitions, ST writes (paper Alg. 2 step 3).

    Sync-free by the paper's §III-B invariant: every write targets a
    distinct freshly inserted node id.  `sel` is the host-side selection
    dict; `new_nodes` is the [p, Fp] id block from Node Insertion.

    This is the mode="loop" reference; ExpansionEngine's batched modes are
    bit-identical rewrites of this function across many slots at once.
    """
    p = sel["leaves"].shape[0]
    leaves = sel["leaves"]
    leaf_states = st.read(leaves)
    sim_nodes = leaves.copy()
    sim_states = leaf_states.copy()
    out = HostExpansion(sim_nodes, sim_states, [], [], [], [], [])
    for j in range(p):
        ea = int(sel["expand_action"][j])
        if ea == NULL:
            continue
        if ea == -2:  # expand-all (Gomoku benchmark mode)
            k = int(sel["n_insert"][j])
            states, nas, terms = [], [], []
            for a in range(k):
                s2, _, term = env.step(leaf_states[j], a)
                states.append(s2)
                nas.append(0 if term else env.num_actions(s2))
                terms.append(int(term))
            ids = new_nodes[j, :k]
            st.write(ids, np.stack(states))
            out.fin_nodes += list(ids)
            out.fin_na += nas
            out.fin_term += terms
            out.prior_parents.append(int(leaves[j]))
            out.prior_workers.append(j)
        else:
            s2, _, term = env.step(leaf_states[j], ea)
            nid = int(new_nodes[j, 0])
            st.write(np.array([nid]), s2[None])
            out.fin_nodes.append(nid)
            out.fin_na.append(0 if term else env.num_actions(s2))
            out.fin_term.append(int(term))
            out.sim_nodes[j] = nid
            out.sim_states[j] = s2
    return out


@dataclasses.dataclass
class PendingExpansion:
    """Handle for an in-flight ``expand_submit``: the flattening already
    happened (leaf reads, per-slot HostExpansion shells, [B] batch rows)
    and the env batch is either posted to the pool workers (``token``) or
    already computed (``eager``, or loop mode's finished ``out``).
    One-shot: ``expand_collect`` consumes it."""

    per: Any            # [(g, st, sel, new_nodes, hx), ...]; None in loop mode
    seg: Any            # [(pos, worker, expand_action, k), ...] batch rows
    out: dict           # {g: HostExpansion} (shells until collect scatters)
    token: Any = None   # the venv's PendingBatch while the IPC is in flight
    eager: Any = None   # (nxt, term, na_raw) when computed at submit
    counted: bool = False  # metrics already recorded


class ExpansionEngine:
    """Batched host-expansion across every active slot of a superstep.

    ``expand(slots)`` takes ``[(g, st, sel, new_nodes), ...]`` — one entry
    per active slot, with that slot's StateTable, host-side selection dict
    and [p, Fp] inserted-id block — and returns ``{g: HostExpansion}``.
    ``expand_submit`` / ``expand_collect`` are its two halves.
    """

    def __init__(self, env, mode: str = "loop", pool_workers: int = 2,
                 tracer=None, metrics=None):
        if mode not in EXPANSION_MODES:
            raise ValueError(f"expansion mode {mode!r}: one of "
                             f"{EXPANSION_MODES}")
        if mode == "auto":
            mode = "vector" if has_vector_env(env) else "loop"
        if mode == "vector" and not has_vector_env(env):
            raise ValueError(
                f"expansion='vector' needs step_batch/num_actions_batch on "
                f"{type(env).__name__}; use 'pool' (process-pool scalar "
                f"fallback) or 'loop'")
        self.env, self.mode = env, mode
        self._venv = (PoolVectorEnv(env, pool_workers) if mode == "pool"
                      else env)
        self.trace = NULL_TRACER if tracer is None else tracer
        reg = NULL_REGISTRY if metrics is None else metrics
        self._m_calls = reg.counter(
            "service_expand_batch_calls_total",
            "env batch round-trips issued by the expansion engine",
            mode=mode)
        self._m_rows = reg.counter(
            "service_expand_rows_total",
            "nodes expanded (env transitions) by the expansion engine",
            mode=mode)

    def expand(self, slots, tid: int = 0) -> dict:
        with self.trace.span("expand", cat="phase", tid=tid,
                             slots=len(slots) if hasattr(slots, "__len__")
                             else -1, mode=self.mode):
            if self.mode == "loop":
                return self._loop(slots).out
            pend = self._submit_batched(list(slots))
            out = self._collect_batched(pend)
            self._count(pend)
            return out

    # -- asynchronous split (overlap mode's host half) ------------------
    def expand_submit(self, slots, tid: int = 0) -> PendingExpansion:
        """Flatten every slot's pending expansions and, in pool mode, post
        the env batch to the workers without waiting.  Modes without an
        async leg compute here; either way the handle goes through
        expand_collect, and submit + collect is bit-identical to
        expand()."""
        with self.trace.span("expand-submit", cat="phase", tid=tid,
                             slots=len(slots) if hasattr(slots, "__len__")
                             else -1, mode=self.mode):
            if self.mode == "loop":
                return self._loop(slots)
            return self._submit_batched(list(slots))

    def expand_collect(self, pending: PendingExpansion, tid: int = 0) -> dict:
        """Redeem an expand_submit handle: block on the posted env batch
        (if one is in flight) and finish the finalize metadata and the ST
        scatter."""
        if pending.per is None:       # loop mode: computed at submit
            return pending.out
        with self.trace.span("expand-collect", cat="phase", tid=tid,
                             mode=self.mode):
            out = self._collect_batched(pending)
            self._count(pending)
            return out

    def _loop(self, slots) -> PendingExpansion:
        out = {g: host_expand_phase(self.env, st, sel, nn)
               for g, st, sel, nn in slots}
        rows = sum(len(hx.fin_nodes) for hx in out.values())
        self._m_calls.inc(rows)     # loop mode: one scalar env.step per row
        self._m_rows.inc(rows)
        return PendingExpansion(per=None, seg=None, out=out, counted=True)

    def _count(self, pending: PendingExpansion) -> None:
        if not pending.counted:
            rows = sum(len(hx.fin_nodes) for hx in pending.out.values())
            self._m_calls.inc(1 if rows else 0)
            self._m_rows.inc(rows)
            pending.counted = True

    # -- one flattened batch over all slots' pending expansions ---------
    def _submit_batched(self, slots) -> PendingExpansion:
        per, seg = [], []
        flat_states, flat_actions = [], []
        for pos, (g, st, sel, new_nodes) in enumerate(slots):
            leaves = sel["leaves"]
            leaf_states = st.read(leaves)
            hx = HostExpansion(leaves.copy(), leaf_states.copy(),
                               [], [], [], [], [])
            per.append((g, st, sel, new_nodes, hx))
            for j in range(leaves.shape[0]):
                ea = int(sel["expand_action"][j])
                if ea == NULL:
                    continue
                if ea == -2:  # expand-all: k rows of the same leaf state
                    k = int(sel["n_insert"][j])
                    for a in range(k):
                        flat_states.append(leaf_states[j])
                        flat_actions.append(a)
                    seg.append((pos, j, ea, k))
                else:
                    flat_states.append(leaf_states[j])
                    flat_actions.append(ea)
                    seg.append((pos, j, ea, 1))
        pend = PendingExpansion(per=per, seg=seg,
                                out={g: hx for (g, _, _, _, hx) in per})
        if not seg:  # saturated/terminal superstep: nothing to expand
            return pend
        states = np.stack(flat_states)
        actions = np.asarray(flat_actions, np.int64)
        if has_async_step(self._venv):
            # post once, wait at collect: the workers step their chunks
            # while the caller's thread runs another gang's superstep
            pend.token = self._venv.submit_batch(states, actions)
        elif has_fused_step(self._venv):
            nxt, _, term, na_raw = self._venv.step_and_count_batch(
                states, actions)
            pend.eager = (nxt, term, na_raw)
        else:
            nxt, _, term = self._venv.step_batch(states, actions)
            pend.eager = (nxt, term, self._venv.num_actions_batch(nxt))
        return pend

    def _collect_batched(self, pending: PendingExpansion) -> dict:
        per, seg, out = pending.per, pending.seg, pending.out
        if not seg:
            return out
        if pending.token is not None:
            nxt, _, term, na_raw = self._venv.collect(pending.token)
            pending.token = None
        else:
            nxt, term, na_raw = pending.eager
        term = np.asarray(term, bool)
        na = np.where(term, 0, np.asarray(na_raw))

        # scatter per (slot, worker) segment; ONE duplicate-checked ST
        # write per slot (every id freshly allocated -> distinct)
        write_ids = [[] for _ in per]
        write_rows = [[] for _ in per]
        off = 0
        for pos, j, ea, k in seg:
            g, st, sel, new_nodes, hx = per[pos]
            rows = range(off, off + k)
            if ea == -2:
                ids = new_nodes[j, :k]
                write_ids[pos] += [int(i) for i in ids]
                write_rows[pos] += list(rows)
                hx.fin_nodes += list(ids)
                hx.fin_na += [int(na[r]) for r in rows]
                hx.fin_term += [int(term[r]) for r in rows]
                hx.prior_parents.append(int(sel["leaves"][j]))
                hx.prior_workers.append(j)
            else:
                nid = int(new_nodes[j, 0])
                write_ids[pos].append(nid)
                write_rows[pos].append(off)
                hx.fin_nodes.append(nid)
                hx.fin_na.append(int(na[off]))
                hx.fin_term.append(int(term[off]))
                hx.sim_nodes[j] = nid
                hx.sim_states[j] = nxt[off]
            off += k
        for pos, (g, st, _, _, _) in enumerate(per):
            if write_ids[pos]:
                st.write(np.asarray(write_ids[pos], np.int64),
                         nxt[write_rows[pos]])
        return out

    def close(self):
        if self.mode == "pool":
            self._venv.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
