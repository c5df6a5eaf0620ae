#!/usr/bin/env python3
"""chip_smoke.py — run the PyTorch/CUDA port's main path on one CUDA card.

    python3 chip_smoke.py

Phases (each raises on any failure, so the exit code is not 0):

  1. device and build: the card's name and power limit (nvidia-smi), and
     the kernels built from src/repro_torch/kernels/csrc with nvcc, all
     at once (with the Selection kernel's stamped copy); for each bf16
     instantiation of the flash kernel, what ptxas -v says (registers,
     spills, wgmma serialized or not), its shared memory and CTAs per
     SM, and the HGMMA instructions in its SASS (cuobjdump -sass), which
     must be there (and absent from the f32 SIMT kernels);
  2. every kernel against its plain torch version on the card, bit for
     bit (zero mismatches in every output array): the TREE_SWEEP configs
     of tests/test_kernels_uct.py x p in {1, 4, 16} x G in {1, 8} with
     random active masks (BackUp with alternating signs on and off, with
     and without a straggler mask), the paper's Pong width (X=56,000,
     F=6, D=9, p=16, G in {1, 8}) and its Gomoku width (X=48,000, F=36,
     D=5, puct, expand-all, p=16, G=1) on seeded random valid trees, and
     the Selection kernel's hazard cases of tests/test_torch_cuda.py
     (tests/tree_cases.py: in-flight counts non-zero at launch,
     p = 48, ln-table entries at the cap and at its low end, a fresh root
     whose children all tie, the Gomoku width);
  3. the main path at Pong width: TreeParallelMCTS with the cuda executor
     against the numpy oracle executor on BanditTreeEnv, superstep by
     superstep until the tree holds X nodes; every selection and the
     final tree must be identical, and each kernel must have launched
     once per superstep;
  4. the main path timed: two run_step() calls (one re-rooting), phase
     times per superstep, supersteps per second, and each kernel's time
     per launch against its plain version and its bound, every timed
     launch starting from the same arena state; uct_select's device
     time at the Gomoku width, whose tree overflows L2; on a tree_floor
     line, each tree kernel's latency floor (a one-thread pointer chase
     over the main path's child array gives the card's dependent L2 load
     latency and the device time of a launch of one load; the floor is
     that launch plus one latency per further dependent level); and on
     select_stamps lines, where a level of the Selection walk goes at both
     widths (uct_select.cu built with its clock64 stamps);
  5. the flash-attention kernel against its plain version (the port's
     naive_attention) on the card: tests/test_flash_kernel.py's SHAPES x
     {f32, bf16} x window {None, 64}, the full-width head shapes of
     llama3.2-1b, starcoder2-3b and gemma3-12b (window 1024 and none) at
     B=1, S=2048, and the shapes the main paths give it at llama3.2-1b
     width (phase 8's B=1 forwards of 2-43 tokens, phase 6's B=4 x 512,
     the serve prefill's B=16 x 2048), within f32 2e-5 / bf16 2e-2; each
     bf16 case is also held, within one bf16 rounding of the output, to
     the plain version run in f32 on the same (bf16) inputs;
  6. full-width llama3.2-1b in an f32 copy (TF32 off): the flash prefill
     against the blockwise prefill on 4 prompts of 512 tokens (max |d
     logits| <= 1e-3) and the same 32 greedy decode tokens; then the
     published bf16 config, reported and not asserted;
  7. the serve entry point (repro_torch.launch.serve) at llama3.2-1b,
     bf16, --batch 16 --prefill 2048 --tokens 64, timed, with the flash
     kernel's time per launch at that shape, and at phase 8's longest
     forward (B=1, S=43), against its plain version (blockwise),
     scaled_dot_product_attention, its bound and the floor of the split-P
     design's own tensor work (1.5x the function's);
  8. the paper's MCTS with the LM as its simulation at full width, bf16:
     TreeParallelMCTS(X=256, F=6, D=4, p=16) over LMTreeEnv and
     LMContinuationBackend, two run_step() calls (the second re-rooting),
     held superstep by superstep against the numpy oracle executor
     replaying the recorded env steps and values; then where its
     superstep goes (one expansion's forward, a decode step, the host
     numpy work per vocabulary row), with device busy shares;
  9. the serving path at the paper's Pong width: one SearchClient
     (executor "cuda", G=16 slots, p=16, weighted-queue-depth policy,
     compaction below half occupancy, vector expansion) over two shape
     classes (X=56,000 and X=28,000, F=6, D=9) on BanditTreeEnv: a
     seeded stream of 32 requests (budgets 64-192 supersteps a move, 1-3
     moves), one cancelled mid-flight, one evicted by a deadline it
     cannot meet, and one that resurrects the half-size class's retired
     pool; every SearchResult must equal a numpy-oracle client's on the
     same stream, sessions must have gathered and scattered, Simulation
     must have been fused across the pools, and each tree kernel must
     have launched once per pool tick; searches/s, ticks, ms per tick by
     phase (untraced, and from a traced run that must also be
     identical); a retired pool must free its arena's memory; the
     relaxed and wavefront executors on the card against themselves on
     the CPU over a short stream; the tree kernels' device time at G=16
     and at a session's 8 slots; Node Insertion (which must not
     synchronise: insert_dev under CUDA's sync debug mode "error"),
     beside its earlier nonzero() form, and finalize, at the main path's
     shape;
 10. the fused K-superstep dispatch at the same width: one G=16 arena on
     the cuda executor, where a dispatch (one captured CUDA graph of the
     superstep body, replayed) must equal the plain (faithful) eager
     body from the same state bit for bit, a submit must run under
     CUDA's sync debug mode "error", and a profiled window of one dispatch's replays must show
     each tree kernel once per replay (the body's device ms and kernel
     count); a short stream over an env whose twin refuses depth >= 2
     leaves, held to a numpy-oracle client, where the expand escape must
     fire; then phase 9's stream through SearchClient(cuda,
     supersteps_per_dispatch=K) for K = 8 and 32 (each twice, in the
     order 8, 32, 32, 8), every SearchResult equal to phase 9's oracle
     results, with commit escapes, fused supersteps on session
     sub-arenas, the kernels' launches equal to the replays plus the
     eager launches, and retired pools freeing their memory;
     searches/s, ms per dispatch by part, and the device's busy share
     over a profiled window of 40 ticks; then ten alternating pairs of
     the stream at K=1 and K=8, each held to the oracle, for the ratio
     of their speeds;
 11. pipelined gangs and sharded pools on phase 9's stream: (a) the
     overlap mode (two gangs, pool expansion with two env worker
     processes, no compaction) at K = 1 and 8, every SearchResult equal
     to a numpy-oracle client's with the same overlap settings and every
     request no cancel or deadline touched equal to phase 9's oracle
     result; a gang staged while another was in flight (K=1) and two
     gangs' fused programs with dispatches in flight at once (K=8);
     every staged gang and every fused gang submit under CUDA's sync
     debug mode "error"; (b) n_shards=2 (both on the one card) at K=1
     with phase 9's compaction and at K=8, equal to phase 9's oracle
     results, each tree kernel launched once per shard with an active
     slot per phase-path tick plus the fused replays and captures;
     (c) three alternating pairs of the stream, overlap against
     lock-step at K=1 (both with pool expansion), each held to its
     oracle, for the ratio of their speeds, searches/s, the
     service_overlap_busy_ratio gauges and the graph captures; (d) no
     env worker process initialised CUDA.

It prints JSON lines; the line before the last is {"kernels": [...]} and
the last is {"ok": true, "device": {...}}.  It imports nothing of the JAX
package.  With no CUDA device it exits 2 before printing any result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
DEV = "cuda"
H100_HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12         # f32 outside the tensor cores
H100_BF16_OPS_PER_S = 989e12       # bf16 dense on the tensor cores

SWEEP = [   # tests/test_kernels_uct.py TREE_SWEEP
    dict(X=64, F=2, D=3),
    dict(X=128, F=4, D=5),
    dict(X=128, F=6, D=4, vl_mode="constant", vl_const=0.5),
    dict(X=256, F=36, D=3, score_fn="puct", leaf_mode="unexpanded",
         expand_all=True),
]


def emit(**kw):
    print(json.dumps(kw), flush=True)


def flash_build_report():
    """Per bf16 instantiation of the flash kernel: ptxas -v's registers and
    spills (from the build log), whether ptxas serialized its wgmma
    (C7511), its shared memory and CTAs per SM, and the HGMMA instructions
    in its SASS.  Raises unless every bf16 instantiation runs on HGMMA and
    the f32 SIMT kernels have none."""
    import re
    import shutil

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA

    lib = build.library_path(FA.NAME)
    ptxas, fn = {}, None
    for ln in lib.with_suffix(".log").read_text().splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", ln):
            fn = m[1]
            ptxas.setdefault(fn, {})
        elif m := re.search(r"function '(\w+)'", ln):
            if "C7511" in ln:
                ptxas.setdefault(m[1], {})["wgmma_serialized"] = True
        elif fn and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)):
            ptxas[fn].update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        elif fn and (m := re.search(r"Used (\d+) registers", ln)):
            ptxas[fn]["registers"] = int(m[1])
    exe = shutil.which("cuobjdump") or str(Path(build.nvcc_path()).parent / "cuobjdump")
    sass = subprocess.run([exe, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    hgmma = {part.split()[0]: part.count("HGMMA")
             for part in sass.split("Function : ")[1:]}
    rows = []
    for dh in FA.HEAD_DIMS:
        name = next(n for n in ptxas if f"wgmma_kernelILi{dh}E" in n)
        rows.append(dict(kernel=f"flash_fwd_wgmma_kernel<{dh}>", **{
            "wgmma_serialized": False, **ptxas[name]}, hgmma=hgmma.get(name, 0),
            **FA.bf16_config(dh)))
    simt = sum(n for f, n in hgmma.items() if "flash_fwd_kernelIf" in f)
    emit(phase="flash_build", bf16=rows, f32_simt_hgmma=simt)
    if simt or not all(r["hgmma"] for r in rows):
        raise AssertionError("a bf16 flash instantiation lacks HGMMA, or the "
                             "f32 SIMT kernel has some")


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

# per kernel: mismatching elements and largest |kernel - plain| over phase 2
AGREEMENT = {"uct_select": [0, 0], "uct_backup": [0, 0],
             "flash_attention": [0, 0.0]}


def compare_trees(kernel: str, x, y, fields) -> int:
    bad = 0
    for k in fields:
        a, b = getattr(x, k).long(), getattr(y, k).long()
        n = int((a != b).sum().item())
        bad += n
        AGREEMENT[kernel][0] += n
        if n:
            AGREEMENT[kernel][1] = max(AGREEMENT[kernel][1],
                                       int((a - b).abs().max().item()))
    return bad


def check_case(cfg, arrays, p, rng) -> int:
    """Select, then backup with alternating signs on and off and with and
    without a straggler mask, kernel vs plain, on one arena (numpy arrays
    with a leading [G] axis; a random active mask when G > 1).
    Returns the number of mismatching elements."""
    from repro_torch.core import intree
    from repro_torch.core.tree import from_numpy, to_numpy
    from repro_torch.kernels import uct_backup, uct_select

    G = arrays["child"].shape[0]
    active = (rng.rand(G) < 0.7).astype(np.int32)
    if G > 1:
        active[rng.randint(G)] = 0
    active[rng.randint(G)] = 1
    act = torch.tensor(active, device=DEV)
    tk, tp = from_numpy(arrays, DEV), from_numpy(arrays, DEV)
    sk = uct_select.select_arena(cfg, tk, act, p)
    sp = uct_select.select_arena_plain(cfg, tp, act, p)
    torch.cuda.synchronize()
    bad = compare_trees("uct_select", sk, sp, intree.SEL_FIELDS)
    bad += compare_trees("uct_select", tk, tp, ("edge_VL", "node_O", "edge_N",
                                                "child"))

    intree.insert_arena(cfg, tk, act, sk)
    new = intree.insert_arena(cfg, tp, act, sp)
    sim = torch.where(sp.expand_action >= 0, new[:, :, 0], sp.leaves).to(torch.int32)
    vals = torch.tensor(rng.randint(-65536, 65537, (G, p)), dtype=torch.int32,
                        device=DEV)
    for alternating, with_drop in ((False, False), (True, False),
                                   (False, True), (True, True)):
        drop = (torch.tensor((rng.rand(G, p) < 0.3).astype(np.int32), device=DEV)
                if with_drop else None)
        bk, bp = from_numpy(to_numpy(tk), DEV), from_numpy(to_numpy(tp), DEV)
        uct_backup.backup_arena(cfg, bk, act, sk, sim, vals, alternating, drop)
        uct_backup.backup_arena_plain(cfg, bp, act, sp, sim, vals, alternating, drop)
        torch.cuda.synchronize()
        bad += compare_trees("uct_backup", bk, bp, (
            "edge_N", "edge_W", "edge_VL", "node_N", "node_O"))
    return bad


def phase_kernels() -> int:
    from repro_torch.core.tree import TreeConfig
    import tree_cases

    rng = np.random.RandomState(0)
    total, n = 0, 0
    for kw in SWEEP:
        cfg = TreeConfig(**kw)
        for p in (1, 4, 16):
            for G in (1, 8):
                bad = check_case(cfg, tree_cases.random_arena(cfg, G, rng), p, rng)
                emit(phase="kernels", case=f"X{cfg.X}-F{cfg.F}-D{cfg.D}-"
                     f"{cfg.vl_mode}-{cfg.score_fn}", p=p, G=G, mismatches=bad)
                total += bad
                n += 1
    for name, kw, G in (("pong", tree_cases.PONG, 1),
                        ("pong", tree_cases.PONG, 8),
                        ("gomoku", tree_cases.GOMOKU, 1)):
        cfg = TreeConfig(**kw)
        t0 = time.perf_counter()
        arrays = tree_cases.random_arena(cfg, G, rng, fill=cfg.X - 50)
        bad = check_case(cfg, arrays, 16, rng)
        emit(phase="kernels", case=name, X=cfg.X, Fp=cfg.Fp, D=cfg.D, p=16,
             G=G, mismatches=bad, seconds=round(time.perf_counter() - t0, 3))
        total += bad
        n += 1
    for name in tree_cases.HAZARDS:   # tests/test_torch_cuda.py's hazard cases
        cfg, arrays, p = tree_cases.hazard(name)
        bad = check_case(cfg, tree_cases.as_slot(arrays), p, rng)
        emit(phase="kernels", case=f"hazard:{name}", X=cfg.X, Fp=cfg.Fp,
             D=cfg.D, p=p, G=1, mismatches=bad)
        total += bad
        n += 1
    if total:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{total} mismatching elements")
    return n


# ---------------------------------------------------------------------------
# phase 3: main path against the numpy oracle, full Pong width
# ---------------------------------------------------------------------------

def phase_main_path():
    from repro_torch.core import TreeConfig, TreeParallelMCTS
    from repro_torch.envs import BanditTreeEnv, BanditValueBackend
    from repro_torch.kernels import uct_backup, uct_select
    from tree_cases import PONG

    cfg = TreeConfig(**PONG)
    mk = lambda ex: TreeParallelMCTS(
        cfg, BanditTreeEnv(fanout=6, terminal_depth=12), BanditValueBackend(),
        p=16, executor=ex, expansion="vector", device=DEV)
    mc, mr = mk("cuda"), mk("reference")
    steps, t_cuda, t_ref = 0, 0.0, 0.0
    uct_select.launches = 0
    uct_backup.launches = 0
    while mc._size() < cfg.X:
        t0 = time.perf_counter()
        a = mc.superstep()
        t1 = time.perf_counter()
        b = mr.superstep()
        t_cuda += t1 - t0
        t_ref += time.perf_counter() - t1
        for k in b:
            if not np.array_equal(a[k], b[k]):
                raise AssertionError(f"superstep {steps}: {k} differs from "
                                     f"the numpy oracle")
        steps += 1
    launches = {"uct_select": uct_select.launches,
                "uct_backup": uct_backup.launches}
    sc, sr = mc.exec.snapshot(mc.tree), mr.exec.snapshot(mr.tree)
    diff = [k for k in sr if not np.array_equal(sc[k], sr[k])]
    if diff:
        raise AssertionError(f"final tree differs from the oracle in {diff}")
    for name, n in launches.items():
        if n != steps:
            raise AssertionError(f"{name} launched {n} times in {steps} supersteps")
    emit(phase="main_path", X=cfg.X, F=cfg.F, D=cfg.D, p=16, supersteps=steps,
         tree_size=int(sc["size"]), identical=True, launches=launches,
         cuda_s=round(t_cuda, 3), reference_s=round(t_ref, 3))
    return mc, launches, steps


# ---------------------------------------------------------------------------
# phase 4: timed run_step + per-kernel times and bounds
# ---------------------------------------------------------------------------

def cuda_time_ms(fn, reset, n: int, warm: int = 3) -> float:
    """Mean ms per call of fn from CUDA events around each call.  reset()
    restores the state fn updates in place before every call, outside the
    timed window, so every timed call does the same work."""
    for _ in range(warm):
        reset()
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    for t0, t1 in ev:
        reset()
        t0.record()
        fn()
        t1.record()
    torch.cuda.synchronize()
    return sum(t0.elapsed_time(t1) for t0, t1 in ev) / n


def device_ms(fn, reset, n: int, kernel: str):
    """Device time per launch of CUDA kernel `kernel` from torch.profiler
    over n calls of fn, each after reset() (None when two traces in a row
    hold no device time for it: the profiler has dropped a session's
    kernel records on this machine once)."""
    from torch.profiler import ProfilerActivity, profile
    reset()
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                reset()
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        for ev in events:
            if kernel in ev.key and ev.count:
                us = getattr(ev, "device_time_total", None)
                if us is None:
                    us = getattr(ev, "cuda_time_total", 0.0)
                if us:
                    return us / 1e3 / ev.count
        emit(phase="profiler", kernel=kernel, found=False,
             keys=[ev.key[:120] for ev in events][:12])
    return None


def phase_timed():
    from repro_torch.core import TreeConfig, TreeParallelMCTS
    from repro_torch.envs import BanditTreeEnv, BanditValueBackend
    from repro_torch.kernels import uct_backup, uct_select
    from tree_cases import PONG

    cfg = TreeConfig(**PONG)
    m = TreeParallelMCTS(cfg, BanditTreeEnv(fanout=6, terminal_depth=12),
                         BanditValueBackend(), p=16, expansion="vector",
                         device=DEV)
    uct_select.launches = 0
    uct_backup.launches = 0
    out = []
    for reuse in (True, False):
        m.stats = type(m.stats)()
        t0 = time.perf_counter()
        a, _, _ = m.run_step(reuse_subtree=reuse)
        wall = time.perf_counter() - t0
        s = m.stats
        n = max(s.supersteps, 1)
        row = dict(phase="run_step", reuse_subtree=reuse, action=int(a),
                   supersteps=s.supersteps, wall_s=wall,
                   supersteps_per_s=s.supersteps / wall,
                   ms_per_superstep={k: 1e3 * getattr(s, "t_" + k) / n for k in (
                       "select", "insert", "st", "sim", "transfer", "backup",
                       "intree", "total")})
        emit(**row)
        out.append(row)
    if uct_select.launches < 1 or uct_backup.launches < 1:
        raise AssertionError("run_step did not go through the kernels")
    return m, out


def select_bound(cfg, sel, G) -> tuple[float, float, int]:
    """Bytes (each distinct input word read once, each output word written
    once) and f32 operations this selection needs, from its own paths."""
    pn = sel.path_nodes.cpu().numpy()
    leaves = sel.leaves.cpu().numpy()
    p, D = pn.shape[1], pn.shape[2]
    n_edge_arrays = 5 if cfg.score_fn == "puct" else 4   # child N W VL (+P)
    rows = nodes = vl_words = 0
    for g in range(G):
        visited = set(pn[g][pn[g] >= 0].tolist())
        rows += len(visited)
        nodes += len(visited | set(leaves[g].tolist()))
        vl_words += len({(int(n), int(a)) for n, a in zip(
            pn[g].ravel(), sel.path_actions[g].cpu().numpy().ravel()) if n >= 0})
    read = (rows * n_edge_arrays * cfg.Fp + nodes * 6) * 4   # + node words, ln
    written = (vl_words + nodes + G * p * (2 * D + 5)) * 4
    ops = rows * cfg.Fp * 12                                  # scoring flops/lane
    levels = int(sel.depths.sum().item())
    return read + written, ops, levels


def backup_bound(cfg, sel, G) -> tuple[float, float]:
    pn = sel.path_nodes.cpu().numpy()
    pa = sel.path_actions.cpu().numpy()
    p, D = pn.shape[1], pn.shape[2]
    edges = nodes = 0
    for g in range(G):
        on = pn[g] >= 0
        edges += len(set(zip(pn[g][on].tolist(), pa[g][on].tolist()))) + p
        nodes += len(set(pn[g][on].tolist()) | set(sel.leaves[g].tolist())) + p
    inputs = G * p * (2 * D + 5) * 4
    rmw = (edges * 3 + nodes * 2) * 4 * 2          # read + write each word
    return inputs + rmw, edges * 3 + nodes * 2


def restorer(tree, fields):
    """A reset() for cuda_time_ms: copies `fields` of `tree` back from a
    snapshot taken now."""
    saved = {k: getattr(tree, k).clone() for k in fields}
    return lambda: [getattr(tree, k).copy_(v) for k, v in saved.items()]


def chase(tree) -> dict:
    """The card's dependent L2 load latency and the device time of a
    launch, from uct_select.cu's one-thread pointer chase
    (uct_chase_launch) over slot 0's child array, with the strong loads
    the selection walk waits on: `latency_ns` from CUDA events at two chain
    lengths, so that the launch cancels out, and `one_load_device_ms`, the
    profiler's device time of a launch that chases one load."""
    import ctypes
    from repro_torch.kernels import build, uct_select

    lib = build.load(uct_select.NAME, {f"{uct_select.NAME}_launch": uct_select.ARGTYPES})
    fn = lib.uct_chase_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    child, start = tree.child[0], int(tree.root[0])
    out = torch.empty(1, dtype=torch.int32, device=DEV)
    stream = torch.cuda.current_stream().cuda_stream
    run = lambda steps: build.check("uct_chase", fn(
        child.data_ptr(), child.shape[1], start, steps, out.data_ptr(), stream))
    none = lambda: None
    n1, n2 = 2_000, 20_000
    t1 = cuda_time_ms(lambda: run(n1), none, 5)
    t2 = cuda_time_ms(lambda: run(n2), none, 5)
    return {"latency_ns": 1e6 * (t2 - t1) / (n2 - n1),
            "one_load_device_ms": device_ms(lambda: run(1), none, 50,
                                            "uct_chase_kernel")}


# uct_select.cu's clock64 stretches (its -DUCT_SELECT_STAMPS note); the
# first six repeat once per level walked
STAMPS = ("leaf_test", "row_wait_child_loads", "ln_wait", "score_argmax",
          "nxt_reds_stores", "next_loads_shuffles", "worker_end", "assign")


def select_stamps(cfg, tree, act, p: int, reset, width: str) -> None:
    """Where a level of the Selection walk goes on `tree`: uct_select.cu
    built with its clock64 stamps (build.VARIANTS: uct_select_stamps),
    launched through the wrapper five times, each after reset().  Emits
    thread 0 of slot 0's cycles per stretch in the last launch: per level
    walked for the level stretches, per worker for a worker's end, and
    the assignment's, with the SM clock nvidia-smi reads just after.  The
    stamped copy's outputs must equal the uninstrumented kernel's."""
    import ctypes
    from repro_torch.core import intree
    from repro_torch.kernels import build, uct_select

    stamped = build.load("uct_select_stamps", {
        "uct_select_launch": uct_select.ARGTYPES,
        "uct_select_cycles_read": [ctypes.c_void_p]})
    reset()
    ref = uct_select.select_arena(cfg, tree, act, p)
    ref_tree = [getattr(tree, k).clone() for k in ("edge_VL", "node_O")]
    plain, n = build._loaded[uct_select.NAME], uct_select.launches
    build._loaded[uct_select.NAME] = stamped   # the wrapper loads it by name
    try:
        for _ in range(5):
            reset()
            sel = uct_select.select_arena(cfg, tree, act, p)
        torch.cuda.synchronize()
    finally:
        build._loaded[uct_select.NAME], uct_select.launches = plain, n
    same = all(torch.equal(getattr(sel, k), getattr(ref, k))
               for k in intree.SEL_FIELDS) and all(
        torch.equal(getattr(tree, k), v)
        for k, v in zip(("edge_VL", "node_O"), ref_tree))
    if not same:
        raise AssertionError(f"uct_select_stamps differs from uct_select ({width})")
    cycles = (ctypes.c_longlong * len(STAMPS))()
    build.check("uct_select_stamps", stamped.uct_select_cycles_read(cycles))
    mhz = int(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    levels = int(sel.depths[0].sum().item())
    per_level = {k: cycles[i] / levels for i, k in enumerate(STAMPS[:6])}
    emit(phase="select_stamps", width=width, identical=True,
         shape=f"G=1 X={cfg.X} Fp={cfg.Fp} D={cfg.D} p={p}", levels=levels,
         total_cycles=sum(cycles), sm_clock_mhz=mhz,
         cycles_per_level=per_level,
         level_cycles=sum(per_level.values()),
         level_us=sum(per_level.values()) / mhz,
         worker_end_cycles_per_worker=cycles[6] / p, assign_cycles=cycles[7])


def gomoku_select() -> dict:
    """uct_select's device ms per launch at the paper's Gomoku width (G=1,
    X=48,000, Fp=64, D=5, puct, expand-all, p=16) on a seeded random tree
    of X - 50 nodes, whose 61 MB of tree arrays overflow the 50 MB L2;
    every timed launch starts from the same tree.  Also where its levels
    go (select_stamps)."""
    from repro_torch.core.tree import TreeConfig, from_numpy
    from repro_torch.kernels import uct_select
    from tree_cases import GOMOKU, random_arena

    cfg, p = TreeConfig(**GOMOKU), 16
    arrays = random_arena(cfg, 1, np.random.RandomState(2), fill=cfg.X - 50)
    ta = from_numpy(arrays, DEV)
    act = torch.ones(1, dtype=torch.int32, device=DEV)
    reset = restorer(ta, ("edge_VL", "node_O"))
    dev = device_ms(lambda: uct_select.select_arena(cfg, ta, act, p), reset,
                    50, "uct_select_kernel")
    reset()
    levels = int(uct_select.select_arena(cfg, ta, act, p).depths.sum().item())
    select_stamps(cfg, ta, act, p, reset, "gomoku")
    return {"gomoku_device_ms": dev, "gomoku_levels": levels,
            "gomoku_shape": f"G=1 X={cfg.X} Fp={cfg.Fp} D={cfg.D} p={p}"}


def kernel_rows(mc, main_launches) -> list:
    """Per-launch times at the main path's shape (Pong, G=1, p=16) on a
    copy of the main path's final tree.  Every timed Selection starts
    from that tree and every timed BackUp from the tree one Selection and
    Insertion later, so all timed launches walk the paths the bound is
    computed from.  The rows hold what this run measured and counted, and
    the bound; the latency floors derived from them go on a tree_floor
    line: a launch that chases one load (chase), then one dependent L2
    load latency per further level of the kernel's chain (Selection: the
    levels this run walked; BackUp: 2, the path's read and then its
    atomics, by its code)."""
    from repro_torch.core import intree
    from repro_torch.core.tree import as_arena, from_numpy
    from repro_torch.kernels import uct_backup, uct_select

    cfg, p = mc.cfg, mc.p
    snap = mc.exec.snapshot(mc.tree)
    act = torch.ones(1, dtype=torch.int32, device=DEV)
    ta = as_arena(from_numpy(snap, DEV))
    reset_sel = restorer(ta, ("edge_VL", "node_O"))
    ms_sel = cuda_time_ms(lambda: uct_select.select_arena(cfg, ta, act, p),
                          reset_sel, 200)
    plain_sel = cuda_time_ms(
        lambda: uct_select.select_arena_plain(cfg, ta, act, p), reset_sel, 5,
        warm=1)
    dev_sel = device_ms(lambda: uct_select.select_arena(cfg, ta, act, p),
                        reset_sel, 50, "uct_select_kernel")
    select_stamps(cfg, ta, act, p, reset_sel, "pong")

    reset_sel()
    sel = uct_select.select_arena(cfg, ta, act, p)
    new = intree.insert_arena(cfg, ta, act, sel)
    sim = torch.where(sel.expand_action >= 0, new[:, :, 0], sel.leaves).to(torch.int32)
    vals = torch.tensor(np.random.RandomState(1).randint(-65536, 65537, (1, p)),
                        dtype=torch.int32, device=DEV)
    reset_bak = restorer(ta, ("edge_N", "edge_W", "edge_VL", "node_N",
                              "node_O"))
    ms_bak = cuda_time_ms(lambda: uct_backup.backup_arena(
        cfg, ta, act, sel, sim, vals), reset_bak, 200)
    plain_bak = cuda_time_ms(lambda: uct_backup.backup_arena_plain(
        cfg, ta, act, sel, sim, vals), reset_bak, 50)
    dev_bak = device_ms(lambda: uct_backup.backup_arena(
        cfg, ta, act, sel, sim, vals), reset_bak, 50, "uct_backup_kernel")

    sb, so, levels = select_bound(cfg, sel, 1)
    bb, bo = backup_bound(cfg, sel, 1)
    lat = chase(ta)
    floors = {}
    for name, n, dev in (("uct_select", levels, dev_sel),
                         ("uct_backup", 2, dev_bak)):
        one = lat["one_load_device_ms"]
        fl = None if one is None else one + (n - 1) * lat["latency_ns"] * 1e-6
        floors[name] = dict(levels=n, device_ms=dev, floor_ms=fl,
                            floor_share=None if fl is None or not dev else fl / dev,
                            us_per_level=None if dev is None else 1e3 * dev / n)
    emit(phase="tree_floor", **lat, **floors)
    rows = []
    for name, src, rep, ms, plain, nbytes, ops, extra in (
        ("uct_select", "src/repro_torch/kernels/csrc/uct_select.cu",
         "src/repro/kernels/uct_select.py:183", ms_sel, plain_sel, sb, so,
         {"device_ms": dev_sel, "levels": levels, **lat, **gomoku_select()}),
        ("uct_backup", "src/repro_torch/kernels/csrc/uct_backup.cu",
         "src/repro/kernels/uct_backup.py:141", ms_bak, plain_bak, bb, bo,
         {"device_ms": dev_bak, **lat}),
    ):
        t_bytes = 1e3 * nbytes / H100_HBM_BYTES_PER_S
        t_ops = 1e3 * ops / H100_F32_OPS_PER_S
        rows.append(dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=main_launches[name], max_abs_err=AGREEMENT[name][1],
            mismatches=AGREEMENT[name][0],
            ms=ms, plain_ms=plain, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None, bytes=int(nbytes), ops=int(ops),
            shape=f"G=1 X={cfg.X} Fp={cfg.Fp} D={cfg.D} p={p}", **extra))
    return rows


# ---------------------------------------------------------------------------
# phase 5: the flash-attention kernel against its plain version
# ---------------------------------------------------------------------------

FLASH_SHAPES = [   # tests/test_flash_kernel.py SHAPES: B, Sq, Sk, H, Hkv, dh
    (1, 128, 128, 2, 2, 32),
    (2, 256, 256, 4, 2, 64),
    (1, 200, 200, 2, 1, 16),
    (2, 384, 384, 8, 8, 128),
]
FULL_WIDTH_HEADS = [   # arch, H, Hkv, head_dim, windows (configs/*.py)
    ("llama3.2-1b", 32, 8, 64, (None,)),
    ("starcoder2-3b", 24, 2, 128, (None,)),
    ("gemma3-12b", 16, 8, 256, (1024, None)),
]
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # test_flash_kernel.py:47
LLAMA = "llama3.2-1b"
SERVE_ARGV = ["--arch", LLAMA, "--batch", "16", "--prefill", "2048",
              "--tokens", "64"]
SERVE_HEADS = (16, 2048, 32, 8, 64)   # the serve prefill's B, S, H, Hkv, dh
# the shapes the LM paths give the kernel (llama3.2-1b heads, causal, no
# window): phase 8's B=1 forwards (a prompt of 1 + seed % 7 tokens plus up
# to MAXLEN - horizon - 1 = 42 expansions; S < 64 leaves one partial query
# tile), phase 6's prefill and the serve prefill
MAIN_PATH_SHAPES = ([(1, S, S, 32, 8, 64) for S in (2, 3, 7, 43)]
                    + [(4, 512, 512, 32, 8, 64),
                       (16, 2048, 2048, 32, 8, 64)])


def randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device=DEV).to(dtype)


def phase_flash() -> int:
    from repro_torch.kernels import flash_attention as FA

    # the f32 references state their matmul precision: TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=DEV).manual_seed(0)
    cases = [(s, w, None) for s in FLASH_SHAPES for w in (None, 64)]
    cases += [((1, 2048, 2048, H, Hkv, dh), w, arch)
              for arch, H, Hkv, dh, windows in FULL_WIDTH_HEADS for w in windows]
    cases += [(s, None, LLAMA + " main path") for s in MAIN_PATH_SHAPES]
    bad, worst, n, worst_share = [], 0.0, 0, 0.0
    for shape, window, arch in cases:
        B, Sq, Sk, H, Hkv, dh = shape
        for dtype, tol in FLASH_TOL.items():
            q = randn(gen, (B, Sq, H, dh), dtype)
            k, v = (randn(gen, (B, Sk, Hkv, dh), dtype) for _ in range(2))
            out = FA.flash_attention(q, k, v, causal=True, window=window).float()
            ref = FA.flash_attention_plain(q, k, v, causal=True,
                                           window=window).float()
            torch.cuda.synchronize()
            err = (out - ref).abs()
            ok = bool((err <= tol + tol * ref.abs()).all())
            e = float(err.max())
            row = dict(max_abs_err=e, tol=tol)
            del ref
            if dtype == torch.bfloat16:
                wide = FA.flash_attention_plain(q.float(), k.float(), v.float(),
                                                causal=True, window=window)
                atol, rtol = FA.BF16_ROUND_TOL
                werr = (out - wide).abs()
                ok_w = bool((werr <= atol + rtol * wide.abs()).all())
                # worst error as a share of its bound (<= 1 passes)
                share = float((werr / (atol + rtol * wide.abs())).max())
                worst_share = max(worst_share, share)
                row.update(max_abs_err_vs_f32=float(werr.max()),
                           tol_share_vs_f32=share, rtol_vs_f32=rtol,
                           ok_vs_f32=ok_w)
                ok = ok and ok_w
                del wide, werr
            worst, n = max(worst, e), n + 1
            emit(phase="flash", shape=list(shape), arch=arch, window=window,
                 dtype=str(dtype).split(".")[-1], ok=ok, **row)
            if not ok:
                bad.append((shape, window, str(dtype)))
            del q, k, v, out, err
    AGREEMENT["flash_attention"] = [len(bad), worst]
    emit(phase="flash", cases=n, outside_tolerance=len(bad), max_abs_err=worst,
         worst_bf16_share_vs_f32=worst_share)
    if bad:
        raise AssertionError(f"flash kernel outside tolerance in {bad}")
    return n


# ---------------------------------------------------------------------------
# phase 6: full-width llama3.2-1b, flash prefill against the plain prefill
# ---------------------------------------------------------------------------

def greedy(cfg, params, tokens, impl, n_new):
    """Prefill `tokens` with `impl`, then n_new greedy decode steps;
    returns (prefill logits [B, V], tokens [B, n_new + 1])."""
    from repro_torch.models import lm, steps

    B, S = tokens.shape
    caches = lm.init_caches(cfg, B, S + n_new + 8, DEV)
    logits, caches = steps.make_prefill_step(cfg, impl=impl)(params, tokens, caches)
    decode = steps.make_decode_step(cfg, impl=impl)
    tok = torch.argmax(logits, -1)[:, None]
    out = [tok]
    positions = torch.arange(S, S + n_new, device=DEV)
    for i in range(n_new):
        lg, caches = decode(params, caches, tok, positions[i])
        tok = torch.argmax(lg, -1)[:, None]
        out.append(tok)
    return logits, torch.cat(out, 1)


def phase_lm_prefill():
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import lm

    # a float32 reference states its matmul precision: TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    published = configs.get_config(LLAMA)
    tokens = torch.randint(0, published.vocab, (4, 512), device=DEV,
                           generator=torch.Generator(device=DEV).manual_seed(1))
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(published, dtype=dtype)
        params = lm.init_params(cfg, torch.Generator(device=DEV).manual_seed(0), DEV)
        FA.launches = 0
        lf, tf = greedy(cfg, params, tokens, "flash", 32)
        launches = FA.launches
        lb, tb = greedy(cfg, params, tokens, "blockwise", 32)
        torch.cuda.synchronize()
        d = float((lf - lb).abs().max())
        agree = float((tf == tb).float().mean())
        finite = bool(torch.isfinite(lf).all())
        emit(phase="lm_prefill", arch=cfg.name, dtype=dtype, batch=4, prompt=512,
             max_abs_logit_diff=d, greedy_tokens=int(tf.numel()),
             greedy_agreement=agree, flash_launches=launches,
             asserted=dtype == "float32", tf32=False)
        if launches != cfg.n_layers:
            raise AssertionError(f"flash launched {launches} times in one "
                                 f"prefill of {cfg.n_layers} layers")
        if not finite:
            raise AssertionError("non-finite prefill logits")
        if dtype == "float32" and (d > 1e-3 or agree != 1.0):
            raise AssertionError(f"f32 flash prefill differs from blockwise: "
                                 f"max |d logits| {d}, agreement {agree}")
        del params


# ---------------------------------------------------------------------------
# phase 7: the serve entry point, timed
# ---------------------------------------------------------------------------

def phase_serve() -> int:
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import serve

    cfg = configs.get_config(LLAMA)
    serve.main(SERVE_ARGV)                 # warm: cuBLAS, allocator, library
    FA.launches = 0
    out = serve.main(SERVE_ARGV)
    launches = FA.launches
    toks = out["tokens"]
    if launches != cfg.n_layers:
        raise AssertionError(f"serve prefill launched flash {launches} times, "
                             f"not {cfg.n_layers}")
    if toks.shape != (16, 65) or toks.min() < 0 or toks.max() >= cfg.vocab:
        raise AssertionError(f"serve tokens out of shape or range: {toks.shape}")
    emit(phase="serve", argv=" ".join(SERVE_ARGV), device=out["device"],
         prefill_ms=1e3 * out["prefill_s"],
         decode_tokens_per_s=16 * 64 / out["decode_s"],
         req_per_s=out["req_per_s"], flash_launches=launches)
    return launches


PHASE8_HEADS = (1, 43, 32, 8, 64)   # phase 8's longest B=1 forward


def flash_timing(shape, seed) -> dict:
    """The flash kernel at one llama3.2-1b bf16 causal shape (B, S, H,
    Hkv, dh): ms per launch from CUDA events and device ms from the
    profiler, against the plain version (blockwise),
    scaled_dot_product_attention and the bound (the function's work).  Its
    flash_row line adds the bytes and operations and the floor of the
    split-P design's tensor work (1.5x the function's); the returned row,
    which goes on the kernels line, holds the measured times and the bound
    only."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models.attention import blockwise_attention

    B, S, H, Hkv, dh = shape
    gen = torch.Generator(device=DEV).manual_seed(seed)
    q = randn(gen, (B, S, H, dh), torch.bfloat16)
    k, v = (randn(gen, (B, S, Hkv, dh), torch.bfloat16) for _ in range(2))
    none = lambda: None
    n0 = FA.launches
    ms = cuda_time_ms(lambda: FA.flash_attention(q, k, v, causal=True), none, 20)
    dev = device_ms(lambda: FA.flash_attention(q, k, v, causal=True), none, 10,
                    "flash_fwd_wgmma")
    FA.launches = n0
    plain = cuda_time_ms(lambda: blockwise_attention(q, k, v, causal=True),
                         none, 3, warm=1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), none, 20)
    lib_dev = wall_and_device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 10)["device_ms"]
    pairs = S * (S + 1) // 2                      # causal (query, key) pairs
    ops = 4 * B * H * dh * pairs
    nbytes = 2 * (2 * B * S * H * dh + 2 * B * S * Hkv * dh)
    t_ops = 1e3 * ops / H100_BF16_OPS_PER_S
    t_bytes = 1e3 * nbytes / H100_HBM_BYTES_PER_S
    split_floor = 1.5 * t_ops
    row = dict(ms=ms, device_ms=dev, plain_ms=plain, library_ms=lib,
               library_device_ms=lib_dev, bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               shape=f"B={B} S={S} H={H} Hkv={Hkv} dh={dh} bf16 causal")
    # the split-P floor is the design's own, not the function's bound: it
    # stays on this line and off the kernels line
    emit(phase="flash_row", **row, bytes=nbytes, ops=ops,
         split_floor_ms=split_floor, split_floor_share=split_floor / (dev or ms))
    return row


def flash_row() -> dict:
    """The flash kernel's row of the kernels line: at the serve prefill's
    shape (llama3.2-1b, bf16, B=16, S=2048), with the same numbers at
    phase 8's shape beside it.  The main path's launch counts are filled
    in by the caller."""
    serve = flash_timing(SERVE_HEADS, 2)
    return dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:88",
        launches=None, max_abs_err=AGREEMENT["flash_attention"][1], **serve,
        at_phase8_shape=flash_timing(PHASE8_HEADS, 3))


# ---------------------------------------------------------------------------
# phase 8: the paper's MCTS with the LM as simulation, full width
# ---------------------------------------------------------------------------

class RecordingEnv:
    """The live env, recording every step's result by (state, action)."""

    def __init__(self, env):
        self.env, self.table, self.steps = env, {}, 0
        self.state_shape, self.state_dtype = env.state_shape, env.state_dtype
        self.max_actions = env.max_actions

    def initial_state(self, seed):
        return self.env.initial_state(seed)

    def num_actions(self, state):
        return self.env.num_actions(state)

    def step(self, state, a):
        out = self.env.step(state, a)
        self.table[(state.tobytes(), int(a))] = out
        self.steps += 1
        return out


class ReplayEnv(RecordingEnv):
    """Replays a RecordingEnv's steps; a step it never saw raises."""

    def __init__(self, rec: RecordingEnv):
        super().__init__(rec.env)
        self.table = rec.table

    def step(self, state, a):
        s2, r, term = self.table[(state.tobytes(), int(a))]
        return s2.copy(), r, term


class RecordingBackend:
    def __init__(self, sim):
        self.sim, self.calls = sim, []

    def evaluate(self, states):
        vals, pri = self.sim.evaluate(states)
        self.calls.append((states.copy(), vals.copy()))
        return vals, pri


class ReplayBackend:
    def __init__(self, rec: RecordingBackend):
        self.calls = iter(rec.calls)

    def evaluate(self, states):
        seen, vals = next(self.calls)
        if not np.array_equal(seen, states):
            raise AssertionError("the reference evaluates other states")
        return vals.copy(), None


def logged(m) -> list:
    """Record each superstep's selection and the tree after it."""
    log, step = [], m.superstep

    def superstep(*a, **kw):
        sel = step(*a, **kw)
        log.append((sel, m.exec.snapshot(m.tree)))
        return sel

    m.superstep = superstep
    return log


def phase_mcts_lm():
    from repro_torch import configs
    from repro_torch.core import TreeConfig, TreeParallelMCTS
    from repro_torch.core.mcts import StepStats
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import uct_backup, uct_select
    from repro_torch.models import lm
    from repro_torch.obs import MetricsRegistry
    from repro_torch.sim import LMContinuationBackend, LMTreeEnv

    cfg = configs.get_config(LLAMA)
    params = lm.init_params(cfg, torch.Generator(device=DEV).manual_seed(0), DEV)
    tree = TreeConfig(X=256, F=6, D=4)
    env = RecordingEnv(LMTreeEnv(cfg, params, fanout=6, horizon=5))
    reg = MetricsRegistry()
    sim = RecordingBackend(LMContinuationBackend(env.env, pool_size=16,
                                                 metrics=reg))
    mc = TreeParallelMCTS(tree, env, sim, p=16, executor="cuda",
                          expansion="loop", device=DEV)
    log_c = logged(mc)
    FA.launches = uct_select.launches = uct_backup.launches = 0
    moves, t0 = [], time.perf_counter()
    for reuse in (False, True):
        mc.stats = StepStats()
        t1 = time.perf_counter()
        a, _, _ = mc.run_step(reuse_subtree=reuse)
        wall = time.perf_counter() - t1
        s, n = mc.stats, max(mc.stats.supersteps, 1)
        tok = int(mc.env.env.tokens(mc.root_state)[-1])
        moves.append(int(a))
        emit(phase="mcts_lm", reuse_subtree=reuse, action=int(a), token=tok,
             supersteps=s.supersteps, wall_s=wall,
             supersteps_per_s=s.supersteps / wall,
             ms_per_superstep={k: 1e3 * getattr(s, "t_" + k) / n for k in (
                 "select", "insert", "st", "sim", "transfer", "backup",
                 "intree", "total")})
    wall = time.perf_counter() - t0
    launches = {"flash_attention": FA.launches, "uct_select": uct_select.launches,
                "uct_backup": uct_backup.launches}
    # full forwards with S > 1: every env step (no cache) and every
    # admission of a prompt longer than one token (a one-token prompt
    # goes through the decode path, as in the JAX package)
    one_token = sum(int((st[:, 0] == 1).sum()) for st, _ in sim.calls)
    admitted = reg.get("serving_admitted_total").value
    forwards = env.steps + admitted - one_token

    mr = TreeParallelMCTS(tree, ReplayEnv(env), ReplayBackend(sim), p=16,
                          executor="reference", expansion="loop", device=DEV)
    log_r = logged(mr)
    ref_moves = [int(mr.run_step(reuse_subtree=reuse)[0])
                 for reuse in (False, True)]
    if len(log_c) != len(log_r):
        raise AssertionError(f"{len(log_c)} supersteps against the oracle's "
                             f"{len(log_r)}")
    for i, ((sc, tc), (sr, tr)) in enumerate(zip(log_c, log_r)):
        for k in sr:
            if not np.array_equal(sc[k], sr[k]):
                raise AssertionError(f"superstep {i}: selection {k} differs")
        for k in tr:
            if not np.array_equal(tc[k], tr[k]):
                raise AssertionError(f"superstep {i}: tree {k} differs")
    if moves != ref_moves:
        raise AssertionError(f"actions {moves} against the oracle's {ref_moves}")
    steps = len(log_c)
    if launches["flash_attention"] != cfg.n_layers * forwards:
        raise AssertionError(f"flash launched {launches['flash_attention']} "
                             f"times for {forwards} full forwards")
    for name in ("uct_select", "uct_backup"):
        if launches[name] != steps:
            raise AssertionError(f"{name} launched {launches[name]} times in "
                                 f"{steps} supersteps")
    emit(phase="mcts_lm", identical=True, supersteps=steps, moves=moves,
         tokens=mc.env.env.tokens(mc.root_state).tolist(), launches=launches,
         full_forwards=forwards, env_steps=env.steps, admissions=admitted,
         one_token_admissions=one_token,
         decode_steps=sim.sim.batcher.decode_steps, wall_s=wall,
         supersteps_per_s=steps / wall)
    phase_lm_costs(cfg, params, env.env, mc.root_state)
    return launches


def wall_and_device_ms(fn, n: int) -> dict:
    """ms per call of fn on the host's clock (ending in a synchronize),
    and the device time of all its kernels per call from torch.profiler
    (summed over the device-side events only: a CPU op's device time
    repeats its kernels'), so busy = device / wall; `top` lists the five
    kernels with the most device time per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0) / n
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    self_ms = sorted(((getattr(e, "self_device_time_total", None)
                       or getattr(e, "self_cuda_time_total", 0.0)) / 1e3 / n,
                      e.key[:90]) for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA)
    dev = sum(ms for ms, _ in self_ms)
    return {"wall_ms": wall, "device_ms": dev, "busy": dev / wall,
            "top": [[k, ms] for ms, k in self_ms[::-1][:5]]}


def phase_lm_costs(cfg, params, env, state):
    """Where phase 8's superstep goes: one LMTreeEnv expansion (a B=1
    forward and the host argsort over the vocabulary), the host log-prob
    of one logits row, and one decode step of the continuation pool
    (B=16) and of the serve shape (B=16 over a 2,120-slot cache)."""
    from repro_torch.models import lm, steps
    from repro_torch.serving.batcher import _logprob

    row = np.random.RandomState(3).randn(cfg.padded_vocab).astype(np.float32)
    host = {}
    for name, fn in (("argsort_vocab", lambda: np.argsort(-row)),
                     ("logprob_row", lambda: _logprob(row, 7))):
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        host[name + "_ms"] = 1e3 * (time.perf_counter() - t0) / 20
    decode = steps.make_decode_step(cfg, impl="flash")
    tok = torch.zeros((16, 1), dtype=torch.long, device=DEV)
    out = {}
    for name, max_seq, pos in (("decode_pool16", 55, 6), ("decode_serve", 2120, 2048)):
        caches = lm.init_caches(cfg, 16, max_seq, DEV)
        posv = torch.full((16,), pos, dtype=torch.int32, device=DEV)
        out[name] = wall_and_device_ms(lambda: decode(params, caches, tok, posv), 10)
    out["top_actions"] = wall_and_device_ms(lambda: env.top_actions(state), 10)
    emit(phase="lm_costs", state_len=int(state[0]), **host, **out)


# ---------------------------------------------------------------------------
# phase 9: the serving path at the paper's Pong width
# ---------------------------------------------------------------------------

SERVE_G, SERVE_P = 16, 16
SERVE_RETIRE_TICKS = 8
CANCEL_UID, DEADLINE_UID, LATE_UID = 2, 32, 33


def serving_stream(seed: int = 0) -> list:
    """The phase's seeded request stream: 32 requests alternating between
    the two shape classes; the Pong class (0) with budgets of 64-192
    supersteps a move and 1-3 moves, the half-size class (1) with 64-96
    and one move, so that it drains and retires while class 0 still
    runs; every eighth keeps its tree.  The request to cancel plays 3
    moves."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(32):
        cls = i % 2
        out.append(dict(uid=i, seed=int(rng.randint(1 << 20)), cls=cls,
                        budget=int(rng.randint(64, 193 if cls == 0 else 97)),
                        moves=int(rng.randint(1, 4)) if cls == 0 else 1,
                        keep_tree=i % 8 == 0))
    out[CANCEL_UID]["moves"] = 3
    return out


def serving_classes():
    from repro_torch.core import TreeConfig
    from tree_cases import PONG

    return [TreeConfig(**PONG), TreeConfig(**dict(PONG, X=28_000))]


def serving_client(executor: str, device=None, env=None, **kw):
    """Phase 9's SearchClient; keyword arguments add to or override its
    settings."""
    from repro_torch.envs import BanditTreeEnv, BanditValueBackend
    from repro_torch.service import SearchClient

    opts = dict(policy="weighted-queue-depth", compact_threshold=0.5,
                retire_after_ticks=SERVE_RETIRE_TICKS, expansion="vector")
    opts.update(kw)
    return SearchClient(env or BanditTreeEnv(fanout=6, terminal_depth=12),
                        BanditValueBackend(), G=SERVE_G, p=SERVE_P,
                        executor=executor,
                        device=DEV if device is None else device, **opts)


def drive_stream(cl, stream) -> dict:
    """Submit the stream (plus one request whose deadline it cannot
    meet), cancel one request after its first move, wait for the
    half-size class's pool to retire, submit one more request to it
    (resurrecting it), and drain.  Returns {uid: SearchResult}."""
    from repro_torch.core.tree import bucket_key
    from repro_torch.service import SearchRequest

    cfgs = serving_classes()
    mk = lambda r: SearchRequest(uid=r["uid"], seed=r["seed"],
                                 budget=r["budget"], moves=r["moves"],
                                 keep_tree=r["keep_tree"], cfg=cfgs[r["cls"]])
    handles = [cl.submit(mk(r)) for r in stream]
    handles.append(cl.submit(mk(dict(uid=DEADLINE_UID, seed=7, cls=0,
                                     budget=192, moves=3, keep_tree=False)),
                             deadline_supersteps=100))
    if not cl.run_until(lambda c: len(c.core.move_log.get(CANCEL_UID, [])) >= 1):
        raise AssertionError("the request to cancel never committed a move")
    if not handles[CANCEL_UID].cancel():
        raise AssertionError("cancel() of an in-flight request failed")
    key1 = bucket_key(cfgs[1])
    if not cl.run_until(lambda c: c.core.pools[key1].retired):
        raise AssertionError("the half-size class's pool never retired")
    handles.append(cl.submit(mk(dict(uid=LATE_UID, seed=11, cls=1, budget=64,
                                     moves=1, keep_tree=True))))
    if cl.core.pools[key1].retired:
        raise AssertionError("a submit did not resurrect the retired pool")
    return {h.uid: h.result() for h in handles}


def results_identical(got: dict, want: dict, label: str) -> int:
    """Raise unless every SearchResult is identical (actions, rewards,
    visit counts, supersteps, flags, every tree snapshot field); returns
    the number of results compared."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"{label}: different requests completed")
    for uid, b in want.items():
        a = got[uid]
        same = ((a.actions, a.rewards, a.supersteps, a.terminal, a.cancelled,
                 a.deadline_evicted) == (b.actions, b.rewards, b.supersteps,
                                         b.terminal, b.cancelled,
                                         b.deadline_evicted)
                and len(a.visit_counts) == len(b.visit_counts)
                and all(np.array_equal(x, y) for x, y in
                        zip(a.visit_counts, b.visit_counts))
                and (a.tree_snapshot is None) == (b.tree_snapshot is None)
                and all(np.array_equal(a.tree_snapshot[k], b.tree_snapshot[k])
                        for k in (b.tree_snapshot or {})))
        if not same:
            raise AssertionError(f"{label}: uid={uid} differs")
    return len(want)


def phase_serving(mc) -> dict:
    """SearchClient at the paper's Pong width (G=16, p=16, cuda executor)
    over two shape classes, held to the numpy-oracle client request for
    request; the same stream traced (ms per tick by phase, and tracing
    must not change a result); relaxed and wavefront on the card held to
    themselves on the CPU; then the tree kernels at G=16 and at the
    largest session width, Node Insertion and finalize at the main
    path's shape, and a retired pool's freed memory.  Returns the tree
    kernels' launches and their serving-shape device times."""
    from repro_torch.kernels import uct_backup, uct_select

    t_phase = time.perf_counter()
    stream = serving_stream()
    uct_select.launches = uct_backup.launches = 0
    cl = serving_client("cuda")
    t0 = time.perf_counter()
    got = drive_stream(cl, stream)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"uct_select": uct_select.launches,
                "uct_backup": uct_backup.launches}
    stats, core = cl.stats, cl.core
    pools = list(core.pools.values())
    summaries = [{k: v for k, v in s.items() if k != "cfg"}
                 for s in cl.pool_summaries()]
    freed = retired_bytes(core)
    cl.close()

    t1 = time.perf_counter()
    ref = serving_client("reference")
    want = drive_stream(ref, stream)
    ref_s = time.perf_counter() - t1
    ref_ticks = ref.core.ticks
    ref.close()
    n = results_identical(got, want, "cuda vs the numpy oracle")
    checks = {
        "launches_per_pool_tick": all(v == stats.supersteps
                                      for v in launches.values()),
        "session_gathers": stats.session_gathers >= 1,
        "session_scatters": stats.session_scatters >= 1,
        "retire_resurrect": stats.retirements >= 1,
        "xpool_batches": core.xpool_batches > 0,
        "cancelled": got[CANCEL_UID].cancelled,
        "deadline_evicted": got[DEADLINE_UID].deadline_evicted,
        "same_ticks": core.ticks == ref_ticks,
    }
    ticks = core.ticks
    emit(phase="serving", executor="cuda", G=SERVE_G, p=SERVE_P,
         classes=[dict(X=c.X, F=c.F, D=c.D) for c in serving_classes()],
         requests=n, identical=True, checks=checks, wall_s=wall,
         searches_per_s=n / wall, ticks=ticks, ticks_per_s=ticks / wall,
         supersteps=stats.supersteps, launches=launches,
         xpool_batches=core.xpool_batches, xpool_rows_max=core.xpool_rows_max,
         session_gathers=stats.session_gathers,
         session_scatters=stats.session_scatters,
         session_reuses=stats.session_reuses,
         compacted_supersteps=stats.compacted_supersteps,
         retirements=stats.retirements, retired_arena_bytes_freed=freed,
         ms_per_tick={k: 1e3 * getattr(stats, "t_" + k) / ticks
                      for k in ("intree", "expand", "host", "sim")},
         occupancy=stats.occupancy_sum / max(stats.supersteps, 1),
         reference_s=ref_s, pools=summaries)
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"serving phase checks failed: {bad} "
                             f"(launches {launches}, supersteps "
                             f"{stats.supersteps})")
    if not all(freed):
        raise AssertionError(f"retire() did not free the arena: {freed}")

    traced_phases(stream, want)
    variants = {v: variant_stream(v) for v in ("relaxed", "wavefront")}
    kernels = serving_kernel_times(mc)
    insert_finalize_times(mc)
    emit(phase="serving", seconds=time.perf_counter() - t_phase,
         variants=variants)
    return {"launches": launches, "want": want, **kernels}


def retired_bytes(core) -> list:
    """For every pool: retire it (the stream has drained) and report
    whether torch.cuda.memory_allocated() fell by at least its arena's
    bytes."""
    out = []
    for pool in core.pools.values():
        if pool.retired:
            continue
        arena = sum(t.numel() * t.element_size()
                    for t in vars(pool.exec.trees).values())
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        if not pool.retire():
            raise AssertionError("an idle pool refused to retire")
        out.append(before - torch.cuda.memory_allocated() >= arena)
    return out


def traced_phases(stream, want):
    """The stream again with tracing on (phases fenced with
    torch.cuda.synchronize): every result must be unchanged, and the
    spans give ms per tick by phase."""
    from repro_torch.obs import Tracer

    tr = Tracer(capacity=1 << 20)
    cl = serving_client("cuda", trace=tr, metrics=True)
    t0 = time.perf_counter()
    got = drive_stream(cl, stream)
    wall = time.perf_counter() - t0
    ticks = cl.core.ticks
    metrics = cl.metrics()
    cl.close()
    results_identical(got, want, "traced cuda vs the numpy oracle")
    ms = {}
    for e in tr.export()["traceEvents"]:
        if e.get("ph") == "X":
            ms[e["name"]] = ms.get(e["name"], 0.0) + e["dur"] / 1e3
    emit(phase="serving_traced", identical=True, wall_s=wall, ticks=ticks,
         ms_per_tick={k: v / ticks for k, v in sorted(ms.items())},
         metrics_lines=len(metrics.splitlines()))


def variant_stream(variant: str) -> dict:
    """A short stream (6 requests, budgets 8-24) through the relaxed or
    wavefront executor on the card and on the CPU: identical results."""
    stream = [dict(r, budget=8 + 4 * (r["uid"] % 5), moves=min(r["moves"], 2))
              for r in serving_stream(1)[:6]]
    out = {}
    for dev in (DEV, "cpu"):
        cl = serving_client(variant, device=dev)
        t0 = time.perf_counter()
        out[dev] = submit_all(cl, stream)
        out[dev + "_s"] = time.perf_counter() - t0
        cl.close()
    n = results_identical(out[DEV], out["cpu"], f"{variant}: card vs CPU")
    return {"requests": n, "identical": True, "card_s": out[DEV + "_s"],
            "cpu_s": out["cpu_s"]}


def submit_all(cl, stream) -> dict:
    from repro_torch.service import SearchRequest

    cfgs = serving_classes()
    hs = [cl.submit(SearchRequest(uid=r["uid"], seed=r["seed"],
                                  budget=r["budget"], moves=r["moves"],
                                  keep_tree=True, cfg=cfgs[r["cls"]]))
          for r in stream]
    return {h.uid: h.result() for h in hs}


def serving_kernel_times(mc) -> dict:
    """Device ms (profiler) of one uct_select and one uct_backup launch
    on G=16 slots and on a session's largest width (8 slots), each slot a
    copy of the main path's final Pong tree, p=16, all slots active."""
    from repro_torch.core import intree
    from repro_torch.core.tree import from_numpy
    from repro_torch.kernels import uct_backup, uct_select

    cfg, p = mc.cfg, mc.p
    snap = mc.exec.snapshot(mc.tree)
    out = {}
    n_sel, n_bak = uct_select.launches, uct_backup.launches
    for G in (SERVE_G, SERVE_G // 2):
        arrays = {k: np.stack([v] * G) for k, v in snap.items()}
        ta = from_numpy(arrays, DEV)
        act = torch.ones(G, dtype=torch.int32, device=DEV)
        reset_sel = restorer(ta, ("edge_VL", "node_O"))
        sel_ms = device_ms(lambda: uct_select.select_arena(cfg, ta, act, p),
                           reset_sel, 30, "uct_select_kernel")
        reset_sel()
        sel = uct_select.select_arena(cfg, ta, act, p)
        new = intree.insert_arena(cfg, ta, act, sel)
        sim = torch.where(sel.expand_action >= 0, new[:, :, 0],
                          sel.leaves).to(torch.int32)
        vals = torch.tensor(np.random.RandomState(G).randint(
            -65536, 65537, (G, p)), dtype=torch.int32, device=DEV)
        reset_bak = restorer(ta, ("edge_N", "edge_W", "edge_VL", "node_N",
                                  "node_O"))
        bak_ms = device_ms(lambda: uct_backup.backup_arena(
            cfg, ta, act, sel, sim, vals), reset_bak, 30, "uct_backup_kernel")
        out[f"G{G}"] = {"uct_select_device_ms": sel_ms,
                        "uct_backup_device_ms": bak_ms}
        del ta
    uct_select.launches, uct_backup.launches = n_sel, n_bak
    emit(phase="serving_kernels", shape=f"X={cfg.X} Fp={cfg.Fp} D={cfg.D} "
         f"p={p}, every slot the main path's final tree", **out)
    return out


def insert_arena_nonzero(cfg, arena, act, sel):
    """Node Insertion in the port's earlier form: the valid lanes found
    with nonzero() (a host sync), then indexed writes.  Timed beside the
    sync-free insert_arena, which must give the same tree."""
    dev = arena.child.device
    G, p = sel.leaves.shape
    Fp = arena.child.shape[2]
    lane = torch.arange(Fp, dtype=torch.int32, device=dev)[None, None, :]
    ea = sel.expand_action[:, :, None]
    single, allmode = ea >= 0, ea == -2
    act_lane = torch.where(single, ea, lane)
    valid = (((single & (lane == 0)) | (allmode & (lane < sel.n_insert[:, :, None])))
             & act[:, None, None])
    nid = sel.insert_base[:, :, None] + torch.where(single, 0, lane)
    vg, vw, vlane = valid.nonzero(as_tuple=True)
    vl = sel.leaves[vg, vw].long()
    va, vn = act_lane[vg, vw, vlane].long(), nid[vg, vw, vlane]
    arena.child[vg, vl, va] = vn
    vn = vn.long()
    arena.node_depth[vg, vn] = arena.node_depth[vg, vl] + 1
    arena.num_actions[vg, vn] = cfg.F
    arena.num_expanded.index_put_(
        (vg, vl), torch.ones_like(vn, dtype=torch.int32), accumulate=True)
    arena.size += (sel.n_insert.sum(1, dtype=torch.int32)
                   * act.to(torch.int32)).to(torch.int32)
    return torch.where(valid, nid, -1).to(torch.int32)


def insert_finalize_times(mc):
    """Node Insertion (sync-free, and the earlier nonzero() form) and
    finalize at the main path's shape (Pong, G=1, p=16) on its final
    tree: host wall per call and device ms per call (profiler, all
    kernels); insert_dev must run under CUDA's sync debug mode "error"."""
    from repro_torch.core import intree, reroot
    from repro_torch.core.executor import CudaExecutor
    from repro_torch.core.tree import NULL, as_arena, from_numpy, to_numpy

    cfg, p = mc.cfg, mc.p
    snap = mc.exec.snapshot(mc.tree)
    root = int(snap["root"])
    # the tree a move commit with subtree reuse leaves: the full tree
    # re-rooted at its most visited child, with room to insert
    arrays, _ = reroot.reroot(cfg, snap, int(snap["child"][root, int(
        np.argmax(snap["edge_N"][root]))]))
    ex = CudaExecutor(cfg, 1, device=DEV, _trees=as_arena(from_numpy(arrays, DEV)))
    active = np.ones(1, bool)
    sel = ex.selection(active, p)
    act = torch.ones(1, dtype=torch.bool, device=DEV)
    base = to_numpy(ex.trees)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dev_block = ex.insert_dev(active, sel)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    new = ex.insert_host(dev_block)
    a, b = from_numpy(base, DEV), from_numpy(base, DEV)
    intree.insert_arena(cfg, a, act, sel)
    insert_arena_nonzero(cfg, b, act, sel)
    same = all(torch.equal(getattr(a, k), getattr(b, k))
               for k in ("child", "node_depth", "num_actions", "num_expanded",
                         "size"))
    if not same:
        raise AssertionError("sync-free insert_arena differs from the "
                             "nonzero() form")
    # repeated insertion of one selection does the same work every call
    new_t = wall_and_device_ms(lambda: intree.insert_arena(cfg, a, act, sel), 50)
    old_t = wall_and_device_ms(lambda: insert_arena_nonzero(cfg, b, act, sel), 50)
    ins = new[new != NULL]
    nodes = np.full((1, p), NULL, np.int32)
    nodes[0, :len(ins)] = ins[:p]
    na = np.where(nodes != NULL, cfg.F, 0).astype(np.int32)
    term = np.zeros_like(nodes)
    fin_t = wall_and_device_ms(lambda: intree.finalize_arena(a, nodes, na, term), 50)
    emit(phase="insert_finalize", shape=f"G=1 X={cfg.X} Fp={cfg.Fp} p={p}",
         tree_size=int(arrays["size"]), inserted=int(len(ins)), insert_dev_sync_free=True, identical=True,
         insert_sync_free=new_t, insert_nonzero=old_t, finalize=fin_t)


# ---------------------------------------------------------------------------
# phase 10: the fused K-superstep dispatch at the paper's Pong width
# ---------------------------------------------------------------------------

FUSED_KS = (8, 32)
FUSED_PAIRS = 10    # alternating K=1 / K=8 stream pairs for the ratio


def partial_env():
    """BanditTreeEnv whose device twin refuses transitions from depth >= 2
    leaves (tests/test_executor_matrix.py's _PartialDeviceEnv): every
    deeper expansion forces the fused dispatch's expand escape."""
    from repro_torch.envs import BanditTreeEnv

    class PartialBanditEnv(BanditTreeEnv):
        def resolvable_device(self, states, actions):
            return states[..., 0] < 2

    return PartialBanditEnv(fanout=6, terminal_depth=12)


SPIN_CYCLES = 2_000_000     # torch.cuda._sleep: about 1 ms of the card


def device_intervals_ms(prof, after_gap: bool = False) -> tuple:
    """(union of the device events' intervals in ms, device events,
    {name: count}) of a torch.profiler trace, spin kernels left out;
    with after_gap, only the events after the widest gap between two
    consecutive ones (a spin kernel's place)."""
    from torch.autograd import DeviceType

    evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                  and "spin_kernel" not in e.name),
                 key=lambda e: e.time_range.start)
    if after_gap and len(evs) > 1:
        gaps = [b.time_range.start - a.time_range.end
                for a, b in zip(evs, evs[1:])]
        evs = evs[1 + int(np.argmax(gaps)):]
    spans = sorted((e.time_range.start, e.time_range.end) for e in evs)
    union, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            union += b - max(a, end)
            end = b
    names: dict = {}
    for e in evs:
        names[e.name] = names.get(e.name, 0) + 1
    return union / 1e3, evs, names


def fused_graph_checks() -> dict:
    """One G=16 arena at the Pong width on the cuda executor: the graph
    dispatch against the plain (faithful) eager body from the same state
    (bit for bit),
    a submit under CUDA's sync debug mode "error", and a profiled window
    of one dispatch's replays (each tree kernel once per replay; the
    body's device ms and kernel count)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import fused
    from repro_torch.core.executor import CudaExecutor
    from repro_torch.core.tree import from_numpy, to_numpy
    from repro_torch.envs import BanditTreeEnv, BanditValueBackend

    cfg, G, p, K = serving_classes()[0], SERVE_G, SERVE_P, 8
    env, sim = BanditTreeEnv(fanout=6, terminal_depth=12), BanditValueBackend()
    ex = CudaExecutor(cfg, G, device=DEV)
    host = np.zeros((G, cfg.X) + env.state_shape, np.float32)
    for g in range(G):
        host[g, 0] = env.initial_state(1000 + g)
        ex.reset_slot(g, env.num_actions(host[g, 0]))
    active = np.ones(G, bool)
    budgets = np.full(G, 10_000, np.int32)
    sizes = np.ones(G, np.int64)

    def rows():
        return [host[g, :sizes[g]] for g in range(G)]

    def absorb(d):
        for g in range(G):
            lo, new = d.written(g)
            host[g, lo: lo + len(new)] = new
        sizes[:] = d.sizes

    t0 = time.perf_counter()
    absorb(ex.run_supersteps(active, p, K, env, sim, rows(), budgets, False))
    capture_s = time.perf_counter() - t0
    absorb(ex.run_supersteps(active, p, K, env, sim, rows(), budgets, False))
    base, base_rows = to_numpy(ex.trees), rows()
    got = ex.run_supersteps(active, p, K, env, sim, base_rows, budgets, False)
    plain = fused.FusedProgram(cfg, "faithful", from_numpy(base, DEV), p, env,
                               sim, False)
    want = plain.collect(plain.submit(active, K, base_rows, budgets))
    same = ((got.n, got.escape) == (want.n, want.escape)
            and all(np.array_equal(getattr(got, k), getattr(want, k))
                    for k in ("size_pre", "sizes", "states_lo"))
            and all(np.array_equal(got.written(g)[1], want.written(g)[1])
                    for g in range(G)))
    a, b = to_numpy(ex.trees), to_numpy(plain.trees)
    same = same and all(np.array_equal(a[k], b[k]) for k in a)
    if not same or got.escape != "ran_k":
        raise AssertionError(f"fused graph dispatch differs from the eager "
                             f"body ({got.escape}/{want.escape})")
    body_ms_events = got.device_ms / got.replays
    del plain
    absorb(got)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pend = ex.run_supersteps_submit(active, p, K, env, sim, rows(),
                                        budgets, False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    absorb(ex.run_supersteps_collect(pend))
    prog = ex.fused_program(p, env, sim, False)
    # the host's cost of queueing a replay (the ST rows the two windows
    # below write stay on the card, where the next bodies read them)
    runs = prog.prepare(active, K, rows(), budgets)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prog.run(runs)
    enqueue_us = 1e6 * (time.perf_counter() - t0) / runs
    torch.cuda.synchronize()
    runs = prog.prepare(active, K, rows(), budgets)
    torch.cuda.synchronize()
    # late in a long process torch.profiler has lost the first kernel
    # records of the first graph launch in a window (15 of 169,
    # uct_select's among them), so one predicated (no-op) replay primes
    # the window, a spin kernel separates it, and only what follows the
    # spin is counted
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prog.stop.fill_(True)
        prog.graph.replay()
        prog.stop.fill_(False)
        torch.cuda._sleep(SPIN_CYCLES)
        prog.run(runs)
        torch.cuda.synchronize()
    union_ms, evs, names = device_intervals_ms(prof, after_gap=True)
    counts = {k: sum(v for n, v in names.items() if k in n)
              for k in ("uct_select_kernel", "uct_backup_kernel")}
    if any(v != runs for v in counts.values()):
        t0 = min(e.time_range.start for e in evs)
        starts = sorted(e.time_range.start - t0 for e in evs
                        if "uct_select_kernel" in e.name)
        raise AssertionError(f"profiled replays: {counts} kernel launches "
                             f"in {runs} replays (uct_select at +{starts} us "
                             f"of {len(evs)} records)")
    ex.release()
    out = {"G": G, "p": p, "replays": runs, "graph_equals_eager": True,
           "submit_sync_free": True, "capture_s": capture_s,
           "enqueue_us_per_replay": enqueue_us,
           "body_device_ms_events": body_ms_events,
           "body_device_ms_profiler": sum(e.time_range.elapsed_us()
                                          for e in evs) / 1e3 / runs,
           "body_busy_ms_profiler": union_ms / runs,
           "body_kernels": len(evs) / runs, "kernel_launches": counts,
           "body_kernel_names": len(names)}
    emit(phase="fused_graph", shape=f"Pong X={cfg.X} Fp={cfg.Fp} D={cfg.D}",
         **out)
    return out


def fused_busy(K: int, stream) -> dict:
    """The device's busy share over a profiled window of the fused stream:
    the stream's requests submitted, 20 ticks run, then 40 ticks under
    torch.profiler (union of the device events' intervals / host wall)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.service import SearchRequest

    cfgs = serving_classes()
    cl = serving_client("cuda", supersteps_per_dispatch=K)
    for r in stream:
        cl.submit(SearchRequest(uid=r["uid"], seed=r["seed"], budget=r["budget"],
                                moves=r["moves"], cfg=cfgs[r["cls"]]))
    cl.poll(20)
    torch.cuda.synchronize()
    s0 = cl.stats.supersteps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ticks = cl.poll(40)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    supersteps = cl.stats.supersteps - s0
    cl.close()
    union_ms, evs, _ = device_intervals_ms(prof)
    return {"ticks": ticks, "pool_supersteps": supersteps, "wall_ms": wall,
            "device_busy_ms": union_ms, "busy": union_ms / wall,
            "device_events": len(evs)}


def fused_expand_stream() -> dict:
    """A short stream (4 requests at the Pong width, budget 24, 1 move)
    over an env whose twin refuses depth >= 2 leaves: the expand escape
    must fire, and every result equal a numpy-oracle client's on the
    same env."""
    stream = [dict(uid=200 + i, seed=31 * i + 3, cls=0, budget=24, moves=1,
                   keep_tree=True) for i in range(4)]
    out = {}
    for ex, K in (("cuda", 8), ("reference", 1)):
        cl = serving_client(ex, env=partial_env(), supersteps_per_dispatch=K)
        t0 = time.perf_counter()
        out[ex] = submit_all(cl, stream)
        out[ex + "_s"] = time.perf_counter() - t0
        out[ex + "_stats"] = cl.stats
        cl.close()
    n = results_identical(out["cuda"], out["reference"],
                          "fused expand escape vs the numpy oracle")
    st = out["cuda_stats"]
    if st.fused_escape_expand == 0:
        raise AssertionError("the expand escape never fired")
    return {"requests": n, "identical": True,
            "escape_expand": st.fused_escape_expand,
            "fused_dispatches": st.fused_dispatches, "card_s": out["cuda_s"],
            "reference_s": out["reference_s"]}


def fused_pairs(stream, want) -> dict:
    """The fused stream's speed against the phase-by-phase one's from
    paired runs: FUSED_PAIRS pairs of phase 9's stream at K=1 and at K=8
    on the cuda executor, alternating which runs first, every result held
    to phase 9's oracle results.  The ratio of each pair's walls, since
    the host's times drift within a call."""
    walls = {1: [], 8: []}
    for i in range(FUSED_PAIRS):
        for K in ((1, 8) if i % 2 == 0 else (8, 1)):
            cl = serving_client("cuda", supersteps_per_dispatch=K)
            t0 = time.perf_counter()
            got = drive_stream(cl, stream)
            torch.cuda.synchronize()
            walls[K].append(time.perf_counter() - t0)
            cl.close()
            results_identical(got, want, f"paired K={K} vs the numpy oracle")
    ratio = [a / b for a, b in zip(walls[1], walls[8])]
    return {"pairs": FUSED_PAIRS, "wall_s_K1": walls[1], "wall_s_K8": walls[8],
            "speed_ratio_K8_over_K1": ratio,
            "median_ratio": float(np.median(ratio)),
            "min_ratio": min(ratio), "max_ratio": max(ratio)}


def phase_fused(want) -> dict:
    """Phase 9's stream through SearchClient(supersteps_per_dispatch=K)
    for K in FUSED_KS, held to phase 9's numpy-oracle results; the
    expand escape on a short stream; the graph against the eager body,
    the sync-free submit and the profiled replays.  Returns the tree
    kernels' launches per K."""
    from repro_torch.core import fused
    from repro_torch.kernels import uct_backup, uct_select

    t_phase = time.perf_counter()
    graph = fused_graph_checks()
    expand = fused_expand_stream()
    emit(phase="fused_expand", **expand)
    stream = serving_stream()
    launches = {}
    walls = {K: [] for K in FUSED_KS}
    capture_ms = {K: [] for K in FUSED_KS}
    # each K twice, in the order 8, 32, 32, 8: the first run pays the
    # process's first launches of the sub-arena widths' kernels (in its
    # captures), and the host's times drift within a call; the detailed
    # line is each K's second run
    for K in FUSED_KS + FUSED_KS[::-1]:
        uct_select.launches = uct_backup.launches = 0
        fused.captures = 0
        fused.capture_s = 0.0
        cl = serving_client("cuda", supersteps_per_dispatch=K)
        t0 = time.perf_counter()
        got = drive_stream(cl, stream)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {"uct_select": uct_select.launches,
                  "uct_backup": uct_backup.launches}
        captures, capture_s = fused.captures, fused.capture_s
        stats, ticks = cl.stats, cl.core.ticks
        replays = stats.fused_replays
        freed = retired_bytes(cl.core)
        cl.close()
        n = results_identical(got, want, f"fused K={K} vs the numpy oracle")
        walls[K].append(wall)
        capture_ms[K].append(1e3 * capture_s)
        # supersteps outside a fused body: ticks capped to one superstep
        # by a deadline run the phase-by-phase path; an expand escape's
        # completion runs one more eager BackUp
        phase_path = (stats.supersteps - stats.fused_supersteps
                      - stats.fused_escape_expand)
        checks = {
            "fused_dispatches": stats.fused_dispatches > 0,
            "escape_commit": stats.fused_escape_commit > 0,
            "fused_on_sessions": stats.fused_compacted_supersteps > 0,
            "select_launches": counts["uct_select"]
            == replays + captures + phase_path,
            "backup_launches": counts["uct_backup"]
            == replays + captures + phase_path + stats.fused_escape_expand,
            "retired_memory_freed": bool(freed) and all(freed),
            "cancelled": got[CANCEL_UID].cancelled,
            "deadline_evicted": got[DEADLINE_UID].deadline_evicted,
        }
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            raise AssertionError(f"fused phase checks failed at K={K}: {bad} "
                                 f"(launches {counts}, replays {replays}, "
                                 f"captures {captures}, phase path "
                                 f"{phase_path})")
        if len(walls[K]) == 1:      # the first run: its wall is reported only
            continue
        d = max(stats.fused_dispatches, 1)
        busy = fused_busy(K, stream)
        emit(phase="fused", K=K, executor="cuda", G=SERVE_G, p=SERVE_P,
             requests=n, identical=True, checks=checks, wall_s=wall,
             searches_per_s=n / wall, ticks=ticks,
             pool_supersteps=stats.supersteps,
             ms_per_pool_superstep=1e3 * wall / stats.supersteps,
             dispatches=stats.fused_dispatches,
             escapes={"ran_k": stats.fused_ran_k,
                      "commit": stats.fused_escape_commit,
                      "expand": stats.fused_escape_expand},
             supersteps_per_dispatch=stats.fused_supersteps / d,
             fused_supersteps=stats.fused_supersteps,
             fused_compacted_supersteps=stats.fused_compacted_supersteps,
             phase_path_supersteps=phase_path, replays=replays,
             captures=captures, capture_ms=1e3 * capture_s,
             launches=counts,
             ms_per_dispatch={
                 "capture": 1e3 * capture_s / d,
                 "host_prep_and_upload":
                     1e3 * (stats.t_fused_submit - capture_s) / d,
                 "device": 1e3 * stats.t_fused_device / d,
                 "read_back": 1e3 * stats.t_fused_collect / d,
                 "commit": 1e3 * stats.t_fused_finish / d,
                 # admission, scheduling and retirement: the rest of the wall
                 "other": 1e3 * (wall - stats.t_fused_submit
                                 - stats.t_fused_collect
                                 - stats.t_fused_finish) / d},
             body_device_ms=graph["body_device_ms_events"],
             body_kernels=graph["body_kernels"],
             busy_window=busy, retired_arena_bytes_freed=freed,
             session_gathers=stats.session_gathers)
        launches[K] = counts
    emit(phase="fused_paired", **fused_pairs(stream, want))
    emit(phase="fused", seconds=time.perf_counter() - t_phase,
         wall_s={f"K{K}": w for K, w in walls.items()},
         capture_ms={f"K{K}": c for K, c in capture_ms.items()},
         searches_per_s={f"K{K}": [len(want) / x for x in w]
                          for K, w in walls.items()})
    return launches


# ---------------------------------------------------------------------------
# phase 11: pipelined gangs (overlap) and sharded pools at the Pong width
# ---------------------------------------------------------------------------

# the overlap mode's client: two gangs, pool expansion (two env worker
# processes), no compaction (overlap refuses it)
OVERLAP = dict(overlap=True, n_gangs=2, compact_threshold=0.0,
               expansion="pool", pool_workers=2)
OVERLAP_KS = (1, 8)
SHARDS = 2
OVERLAP_PAIRS = 3   # alternating overlap / lock-step stream pairs


class PipelineProbe:
    """For one run (undone by close()): wraps ArenaPool._stage and
    ArenaPool._fused_submit_gang to run under CUDA's sync debug mode
    "error" and to count the stages made while another gang was in
    flight and the most fused programs in flight at once; wraps
    ShardedExecutor.selection to count the shards with an active slot
    (the tree-kernel launches a sharded phase calls for)."""

    def __init__(self):
        from repro_torch.core.sharded import ShardedExecutor
        from repro_torch.service.pool import ArenaPool

        self.stages = self.coexist = self.submits = 0
        self.programs_in_flight = 0
        self.shard_launches = 0
        stage, submit = ArenaPool._stage, ArenaPool._fused_submit_gang
        selection = ShardedExecutor.selection
        self._saved = [(ArenaPool, "_stage", stage),
                       (ArenaPool, "_fused_submit_gang", submit),
                       (ShardedExecutor, "selection", selection)]
        probe = self

        def staged(pool, gang, active):
            probe.stages += 1
            probe.coexist += pool._inflight is not None
            with sync_errors():
                return stage(pool, gang, active)

        def submitted(pool, gang, active, K):
            with sync_errors():
                out = submit(pool, gang, active, K)
            probe.submits += 1
            children = [c for c, _, _ in getattr(pool.exec, "shards",
                                                 [(pool.exec, 0, 0)])]
            probe.programs_in_flight = max(probe.programs_in_flight, sum(
                prog._in_flight for c in children for prog in c._fused.values()))
            return out

        def selected(ex, active, p):
            act = np.asarray(active, bool)
            probe.shard_launches += max(1, sum(
                bool(act[lo:lo + n].any()) for _, lo, n in ex.shards))
            return selection(ex, active, p)

        ArenaPool._stage = staged
        ArenaPool._fused_submit_gang = submitted
        ShardedExecutor.selection = selected

    def close(self):
        for cls, name, fn in self._saved:
            setattr(cls, name, fn)


class sync_errors:
    """CUDA's sync debug mode "error" for the block: any host sync
    inside it raises."""

    def __enter__(self):
        torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")


def probed_run(stream, executor="cuda", **kw) -> dict:
    """Phase 9's stream through serving_client(executor, **kw) under a
    PipelineProbe, with the kernels' launches, fused captures and replays
    counted from zero.  Returns the results, the wall, the counts and
    the client's stats, gauges and env workers' CUDA state."""
    from repro_torch.core import fused
    from repro_torch.kernels import uct_backup, uct_select

    uct_select.launches = uct_backup.launches = 0
    fused.captures, fused.capture_s = 0, 0.0
    probe = PipelineProbe()
    cl = serving_client(executor, metrics=True, **kw)
    try:
        t0 = time.perf_counter()
        got = drive_stream(cl, stream)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        venv = cl.core.expander._venv
        workers = (venv.probe_workers()
                   if hasattr(venv, "probe_workers") else {})
        gauges = cl.registry.snapshot().get("service_overlap_busy_ratio", {})
        stats, ticks = cl.stats, cl.core.ticks
    finally:
        probe.close()
        cl.close()
    return {"got": got, "wall": wall, "stats": stats, "ticks": ticks,
            "launches": {"uct_select": uct_select.launches,
                         "uct_backup": uct_backup.launches},
            "captures": fused.captures, "capture_ms": 1e3 * fused.capture_s,
            "probe": probe, "workers": workers, "gauges": gauges}


def untouched(results: dict) -> dict:
    """The results no cancel and no deadline touched."""
    return {uid: r for uid, r in results.items()
            if uid not in (CANCEL_UID, DEADLINE_UID)}


def overlap_runs(stream, want) -> dict:
    """(a) the overlap client (two gangs, pool expansion) at K in
    OVERLAP_KS, each result equal to the numpy-oracle client's with the
    same overlap settings and every untouched request equal to phase 9's
    oracle result; both gangs in flight at once, and at K=8 two fused
    programs' dispatches in flight at once; (d) no env worker
    initialised CUDA.  Returns the oracle's results and the launches."""
    t0 = time.perf_counter()
    # vector expansion: bit-identical to pool expansion, without the IPC
    ref = serving_client("reference", **dict(OVERLAP, expansion="vector"))
    want_ov = drive_stream(ref, stream)
    ref.close()
    ref_s = time.perf_counter() - t0
    results_identical(untouched(want_ov), untouched(want),
                      "overlap oracle vs the lock-step oracle (untouched)")
    launches = {}
    for K in OVERLAP_KS:
        r = probed_run(stream, supersteps_per_dispatch=K, **OVERLAP)
        n = results_identical(r["got"], want_ov,
                              f"overlap K={K} vs the overlap oracle")
        st, probe = r["stats"], r["probe"]
        phase_path = st.supersteps - st.fused_supersteps - st.fused_escape_expand
        checks = {
            # a phase-path gang staged while another was in flight, or
            # (K > 1) two gangs' fused dispatches in flight at once
            "gangs_in_flight_together": (probe.coexist > 0 if K == 1
                                         else probe.programs_in_flight >= 2),
            "workers_without_cuda": bool(r["workers"])
            and not any(r["workers"].values()),
            "select_launches": r["launches"]["uct_select"]
            == st.fused_replays + r["captures"] + phase_path,
            "backup_launches": r["launches"]["uct_backup"]
            == st.fused_replays + r["captures"] + phase_path
            + st.fused_escape_expand,
        }
        if K > 1:
            checks["fused_dispatches"] = st.fused_dispatches > 0
        emit(phase="overlap", K=K, G=SERVE_G, p=SERVE_P, requests=n,
             identical=True, checks=checks, wall_s=r["wall"],
             searches_per_s=n / r["wall"], ticks=r["ticks"],
             pool_supersteps=st.supersteps, stages=probe.stages,
             stages_with_a_gang_in_flight=probe.coexist,
             fused_submits=probe.submits,
             fused_programs_in_flight_max=probe.programs_in_flight,
             fused_dispatches=st.fused_dispatches,
             fused_supersteps=st.fused_supersteps, replays=st.fused_replays,
             captures=r["captures"], capture_ms=r["capture_ms"],
             launches=r["launches"], busy_ratio=r["gauges"],
             env_workers_cuda_initialized=r["workers"],
             reference_s=ref_s)
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            raise AssertionError(f"overlap checks failed at K={K}: {bad}")
        launches[K] = r["launches"]
    return {"want": want_ov, "launches": launches}


def shard_runs(stream, want) -> dict:
    """(b) n_shards=2 (both shards on the one card) with phase 9's
    settings at K=1 (compaction included) and K=8: every result equal to
    phase 9's oracle, and the tree kernels' launches equal to the shards
    with an active slot summed over the phase-path ticks, plus the fused
    replays and captures."""
    launches = {}
    for K in OVERLAP_KS:
        r = probed_run(stream, supersteps_per_dispatch=K, n_shards=SHARDS)
        n = results_identical(r["got"], want, f"shards K={K} vs the oracle")
        st, probe = r["stats"], r["probe"]
        expect = st.fused_replays + r["captures"] + probe.shard_launches
        checks = {
            "select_launches": r["launches"]["uct_select"] == expect,
            "backup_launches": r["launches"]["uct_backup"]
            == expect + st.fused_escape_expand,
            "sessions": K > 1 or st.session_gathers >= 1,
            "fused_dispatches": K == 1 or st.fused_dispatches > 0,
        }
        emit(phase="shards", K=K, n_shards=SHARDS, G=SERVE_G, p=SERVE_P,
             requests=n, identical=True, checks=checks, wall_s=r["wall"],
             searches_per_s=n / r["wall"], ticks=r["ticks"],
             pool_supersteps=st.supersteps,
             shard_phase_launches=probe.shard_launches,
             fused_dispatches=st.fused_dispatches, replays=st.fused_replays,
             captures=r["captures"], capture_ms=r["capture_ms"],
             session_gathers=st.session_gathers, launches=r["launches"])
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            raise AssertionError(f"shard checks failed at K={K}: {bad} "
                                 f"(launches {r['launches']}, expected "
                                 f"{expect})")
        launches[K] = r["launches"]
    return launches


def overlap_pairs(stream, want, want_ov) -> dict:
    """(c) OVERLAP_PAIRS alternating pairs of the stream at K=1 with pool
    expansion, overlap against lock-step, each held to its oracle: the
    ratio of their speeds (lock-step wall over overlap wall), searches/s,
    the busy-ratio gauges and the captures."""
    lock = dict(compact_threshold=0.0, expansion="pool", pool_workers=2)
    walls = {"overlap": [], "lockstep": []}
    gauges = []
    for i in range(OVERLAP_PAIRS):
        order = (("overlap", OVERLAP), ("lockstep", lock))
        for mode, kw in (order if i % 2 == 0 else order[::-1]):
            r = probed_run(stream, **kw)
            results_identical(r["got"], want_ov if mode == "overlap" else want,
                              f"paired {mode} vs its oracle")
            walls[mode].append(r["wall"])
            if mode == "overlap":
                gauges.append(r["gauges"])
    ratio = [a / b for a, b in zip(walls["lockstep"], walls["overlap"])]
    n = len(want)
    return {"pairs": OVERLAP_PAIRS, "wall_s": walls,
            "searches_per_s": {k: [n / w for w in v] for k, v in walls.items()},
            "speed_ratio_overlap_over_lockstep": ratio,
            "median_ratio": float(np.median(ratio)), "min_ratio": min(ratio),
            "max_ratio": max(ratio), "busy_ratio": gauges}


def phase_overlap(want) -> dict:
    """Phase 11: the overlap mode and sharded pools on phase 9's stream,
    held to the numpy oracle.  Returns the tree kernels' launches."""
    t_phase = time.perf_counter()
    stream = serving_stream()
    ov = overlap_runs(stream, want)
    shards = shard_runs(stream, want)
    emit(phase="overlap_paired", **overlap_pairs(stream, want, ov["want"]))
    emit(phase="overlap", seconds=time.perf_counter() - t_phase)
    return {"overlap": ov["launches"], "shards": shards}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tests"))     # tree_cases: seeded trees
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    gpu = gpu_line()
    print(gpu, flush=True)
    t0 = time.perf_counter()
    logs = build.build_all(build.KERNELS + tuple(build.VARIANTS))
    secs = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in logs.items()}
    emit(phase="build", seconds=round(secs, 3), built=sorted(logs), ptxas=ptxas)
    flash_build_report()

    n_cases = phase_kernels()
    emit(phase="kernels", cases=n_cases, mismatches=0)
    mc, launches, steps = phase_main_path()
    phase_timed()
    kernels = kernel_rows(mc, launches)
    phase_flash()
    phase_lm_prefill()
    serve_launches = phase_serve()
    flash = flash_row()
    lm_launches = phase_mcts_lm()
    kernels.append(dict(flash, launches=lm_launches["flash_attention"],
                        launches_serve=serve_launches))
    serving = phase_serving(mc)
    fused_launches = phase_fused(serving["want"])
    overlap_launches = phase_overlap(serving["want"])
    for row in kernels[:2]:
        row["launches_serving"] = serving["launches"][row["name"]]
        row["launches_fused"] = {f"K{K}": fused_launches[K][row["name"]]
                                 for K in FUSED_KS}
        for mode, counts in overlap_launches.items():
            row[f"launches_{mode}"] = {f"K{K}": counts[K][row["name"]]
                                       for K in OVERLAP_KS}
        row["serving_device_ms"] = {
            f"G{G}": serving[f"G{G}"][row["name"] + "_device_ms"]
            for G in (SERVE_G, SERVE_G // 2)}
    emit(phase="total", seconds=round(time.perf_counter() - t_start, 3))
    print(gpu, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
