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
     numpy work per vocabulary row), with device busy shares.

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
    emit(phase="total", seconds=round(time.perf_counter() - t_start, 3))
    print(gpu, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
