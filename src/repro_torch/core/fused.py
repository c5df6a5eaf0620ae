"""Fused K-superstep device dispatch: the serving loop without the
per-phase host round trip (the port of repro.core.fused).

The BSP superstep of service.pool returns to Python between every phase
of every superstep (select -> read -> insert -> read -> host expand ->
finalize -> backup); at small and medium G that dispatch overhead, not
kernel time, bounds throughput.  The paper's in-tree speedup comes from
keeping tree state next to the accelerator and crossing the host
boundary rarely; this module applies the same lesson to the serving
loop.  One dispatch runs, for up to K supersteps with no host read
between them,

    select -> insert -> device expand (env twin) -> device simulate
    (sim twin) -> finalize -> backup

with the sim-state buffer on the device for the whole dispatch.  It
escapes to the host early only when

  * an expansion needs the env (``resolvable_device`` says no): the
    dispatch stops post-insert, carrying that superstep's
    SelectionResult and new node ids so the host completes it through
    the ordinary ExpansionEngine path (``expand``), or
  * a move-commit boundary is hit (a slot's move budget is spent, its
    arena is full, or it did not grow): the dispatch stops after the
    superstep that hit it, so the host commits moves (``commit``).

Bit-identity contract: supersteps are grouping-independent.  Every
phase inside is the op the phase-by-phase path runs, the env/sim twins
are bit-equal to their host halves (envs.device), and the escapes fall
exactly where the K=1 path goes to the host anyway.

JAX's early-exit ``lax.while_loop`` has no torch twin.  Here the
superstep body is PREDICATED: it reads a device ``stop`` flag and masks
every phase with ``active & ~stop``, so a superstep after the stop is a
bit-exact no-op (both tree kernels leave inactive slots untouched, and
every write of the body adds 0 or lands on a sink row).  A dispatch runs
the body a fixed number of times: at most K, and no more than the
smallest remaining move budget of an active slot, since that slot's
commit boundary stops the dispatch by then.  The escaping superstep of
an ``expand`` keeps its post-insert arena; its finalize, BackUp and ST
write are masked off, and its SelectionResult and new node ids go to
carry buffers.

One CUDA graph per body: on the ``cuda`` executor on a card the body is
captured once (``FusedProgram``, cached by the executor per cfg, variant,
p, Ge, env, sim, alternating and the arena's storage addresses) and a
dispatch replays it; nothing in the body reads the device from the host,
so ``submit_supersteps`` issues no sync and ``collect_supersteps`` is the
one read.  Everywhere else (the CPU, and the plain faithful / relaxed /
wavefront executors, whose ops may sync) the same body runs eagerly: it
is the plain version the graph is held to.  A capture that fails raises;
the cuda executor never runs the eager body in the graph's place.

State transfers: the device ST buffer takes only the rows each slot's
env twin can read (those below its size at dispatch start), packed into
one pinned upload, and one pinned read-back brings the escape scalars,
sizes, carry buffers and the rows the dispatch wrote
(``FusedDispatch.states``).

Requires ``not cfg.expand_all`` (prior-producing expansion keeps the
host path) and device twins on both env and sim backend (probes in
envs.device).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import fixedpoint as fx
from repro_torch.core import intree
from repro_torch.core.tree import FIELDS, NULL, TreeConfig, UCTree

# escape reasons surfaced to the pool/scheduler accounting
ESC_RAN_K = 0    # ran all its supersteps, no boundary hit
ESC_COMMIT = 1   # a slot hit a move-commit boundary (stops after that
                 # superstep completes; the host commits moves as usual)
ESC_EXPAND = 2   # an expansion was unresolvable on the device (stops
                 # post-insert; the host completes that superstep)

ESCAPE_NAMES = {ESC_RAN_K: "ran_k", ESC_COMMIT: "commit",
                ESC_EXPAND: "expand"}

# CUDA-graph captures over every FusedProgram (a dispatch counts its own
# replays: FusedDispatch.replays).  A replay launches each tree kernel
# once; the kernel wrappers' own counters see only the eager launches (a
# capture launches nothing, and its count is taken back), so a replay
# adds itself to them where it is issued.
captures = 0
capture_s = 0.0      # host seconds spent capturing (warm-up included)

i32 = torch.int32


@dataclasses.dataclass
class FusedDispatch:
    """Host-side result of one fused dispatch (arrays are numpy)."""

    n: int                      # complete supersteps executed on the device
    escape: str                 # "ran_k" | "commit" | "expand"
    size_pre: np.ndarray        # [Ge] arena size before the most recent
                                # insert (== size after superstep n)
    sizes: np.ndarray           # [Ge] arena size after the dispatch
    states_lo: np.ndarray       # [Ge] arena size at dispatch start
    states: np.ndarray          # [Ge, W, *S] device ST rows of nodes
                                # states_lo[r] + j, j < W (W = p x the
                                # supersteps run); rows past what the
                                # dispatch resolved are junk: written()
    sel_dev: Optional[Any]      # device SelectionResult (escape=="expand")
    sel_host: Optional[dict]    # its host copy
    new_nodes: Optional[np.ndarray]  # [Ge, p, Fp] (escape=="expand")
    replays: int = 0            # superstep bodies run (graph replays on
                                # the cuda executor on a card)
    device_ms: Optional[float] = None  # CUDA events around the replays

    def written(self, r: int) -> tuple[int, np.ndarray]:
        """(lo, rows): the states the device resolved for row r, of
        nodes lo, lo + 1, ...  Node ids are allocated contiguously, so
        they are [size at dispatch start, end), with end the final size,
        or the escaped superstep's pre-insert size on an ``expand`` (the
        host expansion path writes that superstep's rows)."""
        end = int(self.size_pre[r] if self.escape == "expand"
                  else self.sizes[r])
        lo = int(self.states_lo[r])
        return lo, self.states[r, :max(end - lo, 0)]


def _zero_sel(Ge: int, p: int, D: int, device) -> intree.SelectionResult:
    z = lambda *s: torch.zeros(s, dtype=i32, device=device)
    zn = lambda *s: torch.full(s, NULL, dtype=i32, device=device)
    return intree.SelectionResult(
        path_nodes=zn(Ge, p, D), path_actions=zn(Ge, p, D), depths=z(Ge, p),
        leaves=z(Ge, p), expand_action=zn(Ge, p), n_insert=z(Ge, p),
        insert_base=z(Ge, p))


def program_key(cfg: TreeConfig, variant: str, trees: UCTree, p: int, env,
                sim, alternating: bool) -> tuple:
    """What a FusedProgram is specialised on.  env and sim take part by
    identity (the program holds them, so the ids stay theirs), the arena
    by its storage: a graph replays on the addresses it captured."""
    return (cfg, variant, int(p), tuple(trees.child.shape), id(env), id(sim),
            bool(alternating),
            tuple(getattr(trees, k).data_ptr() for k in FIELDS))


@dataclasses.dataclass
class PendingDispatch:
    """A submitted fused dispatch, not yet read to the host.
    submit_supersteps returns one; collect_supersteps waits for it and
    builds the FusedDispatch."""

    program: "FusedProgram"
    runs: int            # superstep bodies queued
    out: torch.Tensor    # the packed read-back (pinned host on a card)
    done: Any            # CUDA event after the read-back copy (None on CPU)
    t0: Any              # CUDA events around the bodies (None on CPU)
    t1: Any


class FusedProgram:
    """The fused superstep body over one arena and its static buffers.

    The ``cuda`` variant on a card captures the body as a CUDA graph and
    only replays it; every other variant, and any variant on the CPU,
    runs it eagerly (the ``faithful`` body on a card is the plain version
    the graph is held to).  One dispatch at a time: submit, then
    collect."""

    def __init__(self, cfg: TreeConfig, variant: str, trees: UCTree, p: int,
                 env, sim, alternating: bool):
        if cfg.expand_all:
            raise ValueError("fused dispatch needs single-expand trees: "
                             "expand-all expansion produces priors on the host")
        dev = trees.child.device
        self.cfg, self.variant, self.trees, self.p = cfg, variant, trees, p
        self.env, self.sim, self.alternating = env, sim, bool(alternating)
        self.key = program_key(cfg, variant, trees, p, env, sim, alternating)
        self.device = dev
        Ge, X = trees.child.shape[0], trees.child.shape[1]
        self.Ge, self.X = Ge, X
        self.S = tuple(env.state_shape)
        self.np_state_dtype = np.dtype(env.state_dtype)
        self.state_dtype = torch.from_numpy(
            np.zeros(0, self.np_state_dtype)).dtype
        if self.np_state_dtype.itemsize != 4:
            raise ValueError(f"fused dispatch reads ST rows back as 4-byte "
                             f"words: state dtype {self.np_state_dtype}")
        z = lambda *s: torch.zeros(s, dtype=i32, device=dev)
        self.active = torch.zeros(Ge, dtype=torch.bool, device=dev)
        self.budget = z(Ge)
        self.stop = torch.ones((), dtype=torch.bool, device=dev)
        self.n, self.esc = z(), z()
        self.size0, self.size_pre = z(Ge), z(Ge)
        self.sel = _zero_sel(Ge, p, cfg.D, dev)
        self.new_nodes = torch.full((Ge, p, cfg.Fp), NULL, dtype=i32,
                                    device=dev)
        # the ST buffer: X rows per slot plus a sink row X that takes the
        # writes of masked-off lanes (the JAX program drops them)
        self.states = torch.zeros((Ge, X + 1) + self.S, dtype=self.state_dtype,
                                  device=dev)
        self._gi = torch.arange(Ge, device=dev)
        self._resolvable = getattr(env, "resolvable_device", None)
        self._kops = None
        if variant == "cuda":
            from repro_torch.kernels import ops as kops   # lazy: core stays kernel-free
            self._kops = kops
        self._staging: dict = {}
        self._in_flight = False
        self.graph = None
        if variant == "cuda" and dev.type == "cuda":
            self._capture()

    # -- the superstep body ------------------------------------------------
    def _select(self, go):
        if self._kops is not None:
            return self._kops.select_arena(self.cfg, self.trees, go, self.p)
        return intree.select_arena(self.cfg, self.trees, go, self.p,
                                   self.variant)

    def _backup(self, go, sel, sim_nodes, values_fx):
        if self._kops is not None:
            return self._kops.backup_arena(self.cfg, self.trees, go, sel,
                                           sim_nodes, values_fx,
                                           self.alternating)
        return intree.backup_arena(self.cfg, self.trees, go, sel, sim_nodes,
                                   values_fx, self.alternating)

    def superstep(self) -> None:
        """One predicated superstep, in place on the arena, the ST buffer
        and the carry buffers; a no-op once ``stop`` is set.  No host read
        (the plain variants' own ops aside), so it can be captured."""
        cfg, a, p, Ge, X = self.cfg, self.trees, self.p, self.Ge, self.X
        gi = self._gi[:, None]
        running = ~self.stop
        go = self.active & running                    # active this superstep
        size_pre = a.size.clone()

        # -- Selection + Node Insertion (the phase-by-phase ops) ----------
        sel = self._select(go)
        new_nodes = intree.insert_arena(cfg, a, go, sel)

        # -- device expansion: resolve new nodes with the env twin --------
        leaf_states = self.states[gi, sel.leaves.long()]        # [Ge,p,*S]
        flat_states = leaf_states.reshape((Ge * p,) + self.S)
        ea = sel.expand_action
        expanding = (ea >= 0) & go[:, None]
        flat_a = ea.clamp(min=0).reshape(-1)        # total fn: clamp masked
        if self._resolvable is None:
            esc_expand = torch.zeros((), dtype=torch.bool, device=self.device)
        else:
            ok = self._resolvable(flat_states, flat_a).reshape(Ge, p)
            esc_expand = (expanding & ~ok).any()
        nxt, term = self.env.step_device(flat_states, flat_a)
        term = term.reshape(Ge, p).to(i32)
        na = self.env.num_actions_device(nxt).to(i32).reshape(Ge, p)
        nxt = nxt.reshape((Ge, p) + self.S)
        nid = new_nodes[:, :, 0]                    # single-expand: lane 0
        done = ~esc_expand
        resolved = expanding & done
        wid = torch.where(resolved, nid, X).long()  # masked lanes -> sink
        self.states.view((-1,) + self.S).index_copy_(
            0, (gi * (X + 1) + wid).reshape(-1), nxt.reshape((-1,) + self.S))

        # -- Simulation on the device (values only) -----------------------
        sim_nodes = torch.where(expanding, nid, sel.leaves)
        exp_s = expanding.reshape((Ge, p) + (1,) * len(self.S))
        sim_states = torch.where(exp_s, nxt, leaf_states)
        vals = self.sim.evaluate_device(sim_states.reshape((Ge * p,) + self.S))
        values_fx = fx.encode(vals).reshape(Ge, p)

        # -- finalize + BackUp (masked off in an escaping superstep) ------
        go_done = go & done
        intree.finalize_arena_device(
            a, torch.where(resolved, nid, NULL), torch.where(resolved, na, 0),
            torch.where(resolved, term, 0))
        self._backup(go_done, sel, sim_nodes, values_fx)

        # -- move-commit boundary (mirrors pool._commit_moves) ------------
        budget2 = self.budget - go_done.to(i32)
        size_after = a.size
        boundary = go_done & ((budget2 <= 0) | (size_after >= X)
                              | (size_after == size_pre))
        hit = boundary.any()

        # -- carry ----------------------------------------------------------
        escaped = running & esc_expand
        self.n += (running & done).to(i32)
        self.budget.copy_(budget2)
        self.size_pre.copy_(torch.where(running, size_pre, self.size_pre))
        code = torch.where(esc_expand, ESC_EXPAND,
                           torch.where(hit, ESC_COMMIT, ESC_RAN_K))
        self.esc.copy_(torch.where(running, code, self.esc))
        for k in intree.SEL_FIELDS:
            c = getattr(self.sel, k)
            c.copy_(torch.where(escaped, getattr(sel, k), c))
        self.new_nodes.copy_(torch.where(escaped, new_nodes, self.new_nodes))
        self.stop |= esc_expand | hit

    # -- the CUDA graph ------------------------------------------------------
    def _capture(self) -> None:
        """Capture the body once as a CUDA graph.  The warm-up run (which
        loads the kernels and runs every op once) and the capture happen
        with ``stop`` set, so the warm-up leaves the arena bit-frozen."""
        global captures, capture_s
        from repro_torch.kernels import uct_backup, uct_select

        t0 = time.perf_counter()
        dev = self.device
        self.stop.fill_(True)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.superstep()
            counts = uct_select.launches, uct_backup.launches
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin()
            try:
                self.superstep()
            finally:
                graph.capture_end()
                # a capture launches nothing
                uct_select.launches, uct_backup.launches = counts
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = graph
        captures += 1
        capture_s += time.perf_counter() - t0

    def run(self, runs: int) -> None:
        """Run the body `runs` times on the prepared dispatch: graph
        replays (each launching each tree kernel once, counted here), or
        eagerly, stopping at the stop flag (a read of the device)."""
        if self.graph is not None:
            from repro_torch.kernels import uct_backup, uct_select

            for _ in range(runs):
                self.graph.replay()
            uct_select.launches += runs
            uct_backup.launches += runs
            return
        for _ in range(runs):
            self.superstep()
            if bool(self.stop):     # eager only: a read of the flag
                break

    # -- transfers -----------------------------------------------------------
    def _buffer(self, name: str, n: int, dtype, least: int = 1) -> torch.Tensor:
        """A staging tensor of n elements, pinned on a card: the first n
        of a buffer of at least `least` elements, doubled when a dispatch
        needs more (so a program allocates pinned memory a few times in
        its life, not per dispatch)."""
        buf = self._staging.get(name)
        if buf is None or buf.numel() < n:
            size = max(n, least, 2 * (0 if buf is None else buf.numel()))
            buf = torch.empty(size, dtype=dtype,
                              pin_memory=self.device.type == "cuda")
            self._staging[name] = buf
        return buf[:n]

    def _upload(self, act: np.ndarray, budget: np.ndarray, states) -> None:
        """One pinned copy of the control block (active mask, budgets,
        destination rows) and one of the ST rows each active slot's env
        twin can read: a [Ge, X, *S] image uploads all X rows of each
        active slot, a sequence of Ge arrays its rows as given (the pool
        passes the rows below each slot's size)."""
        Ge, X, dev = self.Ge, self.X, self.device
        parts = [np.asarray(states[r]) if act[r] and states[r] is not None
                 else None for r in range(Ge)]
        counts = [0 if x is None else len(x) for x in parts]
        total = sum(counts)
        width = int(np.prod(self.S, dtype=np.int64))
        # sized for every row of the arena at once from the start
        ctrl = self._buffer("ctrl", 2 * Ge + total, torch.int32,
                            least=Ge * (X + 2))
        cn = ctrl.numpy()
        cn[:Ge] = act
        cn[Ge:2 * Ge] = budget
        rows = self._buffer("rows", total * width, self.state_dtype,
                            least=Ge * X * width)
        rn = rows.numpy().reshape((total,) + self.S)
        off = 0
        for r, x in enumerate(parts):
            if x is None or not len(x):
                continue
            k = len(x)
            cn[2 * Ge + off: 2 * Ge + off + k] = np.arange(
                r * (X + 1), r * (X + 1) + k, dtype=np.int32)
            rn[off: off + k] = x
            off += k
        ctrl_d = ctrl.to(dev, non_blocking=True)
        self.active.copy_(ctrl_d[:Ge] != 0)
        self.budget.copy_(ctrl_d[Ge:2 * Ge])
        if total:
            self.states.view((-1,) + self.S).index_copy_(
                0, ctrl_d[2 * Ge:].long(),
                rows.to(dev, non_blocking=True).view((total,) + self.S))

    def _read_back(self, runs: int):
        """Pack the escape scalars, sizes, carry buffers and the ST rows
        the dispatch can have written ([size at start, + runs x p) of
        each slot) into one int32 tensor, and start its one copy to the
        host.  Returns (host tensor, done event)."""
        X, W = self.X, runs * self.p
        j = torch.arange(W, device=self.device)
        widx = (self._gi[:, None] * (X + 1)
                + torch.clamp(self.size0[:, None] + j, max=X)).reshape(-1)
        rows = self.states.view((-1,) + self.S).index_select(0, widx)
        parts = ([self.n.view(1), self.esc.view(1), self.size0, self.size_pre,
                  self.trees.size]
                 + [getattr(self.sel, k).reshape(-1) for k in intree.SEL_FIELDS]
                 + [self.new_nodes.reshape(-1),
                    rows.view(torch.int32).reshape(-1)])
        out = torch.cat(parts)
        if self.device.type != "cuda":
            return out, None
        host = self._buffer("down", out.numel(), torch.int32)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    # -- one dispatch ----------------------------------------------------------
    def prepare(self, active, K: int, states, budget_left) -> int:
        """Load a dispatch's inputs (mask, budgets, ST rows) and reset the
        carry, with no host read.  Returns the number of bodies to run:
        K, or fewer when an active slot's remaining budget is smaller
        (that slot's commit boundary stops the dispatch by then, and
        bodies past the stop are no-ops, so they are not queued)."""
        Ge = self.Ge
        act = np.asarray(active, bool).reshape(Ge)
        budget = np.asarray(budget_left, np.int32).reshape(Ge)
        runs = int(K)
        if act.any():
            runs = max(1, min(runs, int(budget[act].min())))
        self._upload(act, budget, states)
        self.stop.zero_()
        self.n.zero_()
        self.esc.zero_()
        self.size0.copy_(self.trees.size)
        self.size_pre.copy_(self.trees.size)
        return runs

    def submit(self, active, K: int, states, budget_left) -> PendingDispatch:
        """Queue up to K predicated supersteps and the read-back, with no
        host read."""
        if self._in_flight:
            raise RuntimeError("a fused dispatch of this program is in "
                               "flight: collect it before the next submit")
        runs = self.prepare(active, K, states, budget_left)
        t0 = t1 = None
        if self.device.type == "cuda":
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
        self.run(runs)
        if t1 is not None:
            t1.record()
        out, done = self._read_back(runs)
        self._in_flight = True
        return PendingDispatch(self, runs, out, done, t0, t1)

    def collect(self, pend: PendingDispatch) -> FusedDispatch:
        """The one blocking read of a dispatch."""
        if pend.done is not None:
            pend.done.synchronize()
        self._in_flight = False
        buf = pend.out.numpy()
        Ge, p, D, Fp = self.Ge, self.p, self.cfg.D, self.cfg.Fp
        W = pend.runs * p
        off = 0

        def take(shape):
            nonlocal off
            n = int(np.prod(shape, dtype=np.int64))
            x = buf[off: off + n].reshape(shape).copy()
            off += n
            return x

        n, esc = int(buf[0]), int(buf[1])
        off = 2
        states_lo, size_pre, sizes = take((Ge,)), take((Ge,)), take((Ge,))
        sel_host = {k: take(tuple(getattr(self.sel, k).shape))
                    for k in intree.SEL_FIELDS}
        new_nodes = take((Ge, p, Fp))
        rows = take((Ge, W) + self.S).view(self.np_state_dtype)
        expand = esc == ESC_EXPAND
        return FusedDispatch(
            n=n, escape=ESCAPE_NAMES[esc], size_pre=size_pre, sizes=sizes,
            states_lo=states_lo, states=rows,
            sel_dev=self.sel.map(torch.clone) if expand else None,
            sel_host=sel_host if expand else None,
            new_nodes=new_nodes if expand else None, replays=pend.runs,
            device_ms=(pend.t0.elapsed_time(pend.t1)
                       if pend.t0 is not None else None))


def submit_supersteps(cfg: TreeConfig, variant: str, trees: UCTree, active,
                      p: int, K: int, env, sim, states, budget_left,
                      alternating: bool):
    """Queue up to K fused supersteps WITHOUT any host read, on a fresh
    FusedProgram (the executors keep one per arena instead).  Returns
    (trees, PendingDispatch); the arena is updated in place."""
    program = FusedProgram(cfg, variant, trees, p, env, sim, alternating)
    return trees, program.submit(active, K, states, budget_left)


def collect_supersteps(pend: PendingDispatch) -> FusedDispatch:
    """Blocking half: the one read of a submitted dispatch."""
    return pend.program.collect(pend)


def run_supersteps(cfg: TreeConfig, variant: str, trees: UCTree, active,
                   p: int, K: int, env, sim, states, budget_left,
                   alternating: bool):
    """Run up to K fused supersteps.  Returns (trees, FusedDispatch).

    ``states`` holds, per dispatched row, the host ST rows its env twin
    may read: a [Ge, X, *S] image, or a sequence of Ge arrays (None for
    a row left out).  New-node states come back in FusedDispatch.states
    (see FusedDispatch.written).  Exactly
    collect_supersteps(submit_supersteps(...))."""
    trees, pend = submit_supersteps(cfg, variant, trees, active, p, K, env,
                                    sim, states, budget_left, alternating)
    return trees, collect_supersteps(pend)
