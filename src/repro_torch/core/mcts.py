"""Tree-Parallel MCTS BSP driver (paper Alg. 2 / Fig. 2), on torch.

The port of repro.core.mcts.  One superstep =
  1. Selection + Node Insertion on the accelerator          (device)
  2. Receive buffer: node indices s, s' -> host              (O(p) transfer)
  3. ST reads, 1-step simulations, ST writes                 (host, sync-free)
  4. Simulation phase (software rollout or NN inference)     (host)
  5. barrier; Send buffer: rewards -> accelerator            (O(p) transfer)
  6. BackUp on the accelerator                               (device)

The driver is executor-agnostic: the in-tree operations run on the
sequential numpy oracle ("reference"), the plain torch ops ("faithful")
or the hand-written CUDA kernels ("cuda", the default), all
bit-compatible.  The phase fences are ``torch.cuda.synchronize`` on a
CUDA device, so each phase time holds that phase's device work.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Protocol

import numpy as np

from repro_torch.core import fixedpoint as fx
from repro_torch.core.executor import (
    InTreeExecutor, ReferenceExecutor, make_intree_executor,
)
from repro_torch.core.expand import ExpansionEngine
from repro_torch.core.state_table import StateTable
from repro_torch.core.tree import NULL, TreeConfig, resolve_device


class Environment(Protocol):
    """Host-side environment (see repro.core.mcts.Environment)."""

    state_shape: tuple
    state_dtype: Any
    max_actions: int

    def initial_state(self, seed: int) -> np.ndarray: ...
    def num_actions(self, state: np.ndarray) -> int: ...
    def step(self, state: np.ndarray, a: int) -> tuple[np.ndarray, float, bool]: ...


class SimulationBackend(Protocol):
    """Maps a batch of states to values (and optionally priors)."""

    def evaluate(self, states: np.ndarray) -> tuple[np.ndarray, np.ndarray | None]: ...


class RolloutBackend:
    """Software simulation until termination (paper's OpenAI-gym path);
    numpy RandomState stream identical to the JAX package's."""

    def __init__(self, env, max_steps: int = 200, seed: int = 0, discount: float = 1.0):
        self.env, self.max_steps, self.discount = env, max_steps, discount
        self.rng = np.random.RandomState(seed)

    def evaluate(self, states):
        vals = np.zeros(len(states), dtype=np.float32)
        for i, s in enumerate(states):
            v, g, cur = 0.0, 1.0, s
            for _ in range(self.max_steps):
                k = self.env.num_actions(cur)
                if k == 0:
                    break
                cur, r, term = self.env.step(cur, int(self.rng.randint(k)))
                v += g * r
                g *= self.discount
                if term:
                    break
            vals[i] = v
        return vals, None


def make_executor(cfg: TreeConfig, name: str, device=None) -> InTreeExecutor:
    """Single-tree executor: the G=1 instance of the executor stack."""
    return make_intree_executor(cfg, 1, name, device=device)


@dataclasses.dataclass
class StepStats:
    supersteps: int = 0
    sim_requests: int = 0
    t_select: float = 0.0
    t_insert: float = 0.0
    t_backup: float = 0.0
    t_transfer: float = 0.0
    t_st: float = 0.0
    t_sim: float = 0.0

    @property
    def t_intree(self) -> float:
        # Paper Fig. 4 metric: Selection + Expansion(tree half) + BackUp
        # + host<->accel transfer + ST operations.
        return self.t_select + self.t_insert + self.t_backup + self.t_transfer + self.t_st

    @property
    def t_total(self) -> float:
        return self.t_intree + self.t_sim


class TreeParallelMCTS:
    """The full system of Fig. 2 on one host — the G=1 client of the
    executor stack (`m.tree` views slot 0 of the executor's arena;
    assigning it writes the slot back).

    Runs on CUDA with the hand-written kernels unless the caller passes
    another `device` / `executor`; with no CUDA device and no
    ``device="cpu"`` it raises."""

    def __init__(
        self,
        cfg: TreeConfig,
        env: Environment,
        sim: SimulationBackend,
        p: int,
        executor: str = "cuda",
        alternating_signs: bool = False,
        seed: int = 0,
        expansion: str = "loop",
        device=None,
    ):
        self.device = resolve_device(device)
        self.cfg, self.env, self.sim, self.p = cfg, env, sim, p
        self.alternating_signs = alternating_signs
        self.exec: InTreeExecutor = make_intree_executor(
            cfg, 1, executor, device=self.device)
        self.expander = ExpansionEngine(env, expansion)
        self.st = StateTable(cfg.X, env.state_shape, env.state_dtype)
        # fixed finalize width (the arena finalize takes one shape per slot)
        self.K = p * cfg.Fp if cfg.expand_all else p
        self.reset(seed)

    @property
    def tree(self):
        return self.exec.get_tree(0)

    @tree.setter
    def tree(self, t):
        self.exec.set_tree(t, 0)

    def reset(self, seed: int = 0):
        s0 = self.env.initial_state(seed)
        self.tree = self.exec.init(self.env.num_actions(s0))
        self.st.flush(s0)
        self.root_state = s0
        self.stats = StepStats()

    # -- one BSP superstep (Alg. 2) ------------------------------------
    def superstep(self, fault_injector=None):
        """One BSP superstep.  `fault_injector(p) -> done[p] bool` models
        simulation workers that miss the barrier; missing workers get a
        VL-recovery-only backup so the tree invariants survive."""
        cfg, p, st = self.cfg, self.p, self.st
        active = np.ones(1, bool)
        t0 = time.perf_counter()
        sel_dev = self.exec.selection(active, p)
        self.exec.block()
        t1 = time.perf_counter()
        sel = self.exec.sel_to_host(sel_dev)           # [1, p, ...]
        slot_sel = {k: v[0] for k, v in sel.items()}
        t2 = time.perf_counter()

        # Node Insertion (tree half, accelerator)
        new_nodes = self.exec.insert(active, sel_dev)  # [1, p, Fp] numpy
        t3 = time.perf_counter()

        # --- host: ST reads + 1-step sims + ST writes (sync-free) ---
        t4 = time.perf_counter()
        hx = self.expander.expand([(0, st, slot_sel, new_nodes[0])])[0]
        sim_nodes = hx.sim_nodes
        t5 = time.perf_counter()

        # --- Simulation phase ---
        values, priors = self.sim.evaluate(hx.sim_states)
        t6 = time.perf_counter()

        # --- barrier; Send buffer -> accelerator; finalize + BackUp ---
        if hx.fin_nodes:   # saturated/terminal supersteps insert nothing
            nodes, na, term, pp, pf = hx.padded_finalize_args(
                self.K, p, cfg.Fp, priors)
            self.exec.finalize(nodes[None], na[None], term[None], pp[None],
                               pf[None])
        values_fx = np.asarray(fx.encode(values), np.int32)
        dropped = None
        if fault_injector is not None:
            done = np.asarray(fault_injector(p), bool)
            dropped = ~done
            if not dropped.any():
                dropped = None
        t7 = time.perf_counter()
        self.exec.backup(
            active, sel_dev, sim_nodes[None].astype(np.int32),
            values_fx[None], self.alternating_signs,
            None if dropped is None else dropped[None])
        self.exec.block()
        t8 = time.perf_counter()

        s = self.stats
        s.supersteps += 1
        s.sim_requests += p
        s.t_select += t1 - t0
        s.t_transfer += (t2 - t1) + (t7 - t6)
        s.t_insert += t3 - t2
        s.t_st += t5 - t4
        s.t_sim += t6 - t5
        s.t_backup += t8 - t7
        return slot_sel

    # -- one MCTS step (paper Fig. 1): build tree to X nodes, act, flush
    def run_step(self, max_supersteps: int = 10_000, reuse_subtree: bool = False):
        """reuse_subtree=True replaces the paper's full Tree Flush with a
        statistics-preserving re-root (core.reroot, beyond-paper); the
        numpy oracle executor always flushes, as in the JAX package."""
        size0 = self._size()
        steps = 0
        while self._size() < self.cfg.X and steps < max_supersteps:
            self.superstep()
            steps += 1
            new_size = self._size()
            if new_size == size0:  # saturated (all leaves terminal/at depth cap)
                break
            size0 = new_size
        a = self.exec.best_action(self.tree)
        new_root_state, reward, term = self.env.step(self.root_state, a)
        snap = self.exec.snapshot(self.tree) if reuse_subtree else None
        self.root_state = new_root_state
        if reuse_subtree and not term and not isinstance(
                self.exec, ReferenceExecutor):
            from repro_torch.core import reroot
            new_root = int(snap["child"][int(snap["root"]), a])
            if new_root != NULL:
                self.tree, old2new = reroot.reroot_tree(
                    self.cfg, snap, new_root, self.device)
                self.st.compact(old2new)
                return a, reward, term
        # paper-faithful full flush
        k = 0 if term else self.env.num_actions(new_root_state)
        self.tree = self.exec.init(max(k, 1))
        self.st.flush(new_root_state)
        return a, reward, term

    def _size(self) -> int:
        return int(self.exec.sizes()[0])

    def close(self):
        """Release expansion-engine resources (process pool, if any)."""
        self.expander.close()
