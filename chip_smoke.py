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
     B=1, S=2048, recurrentgemma-9b's local MQA (H=16, Hkv=1, dh=256,
     window 2048) there and at phase 13's B=4 and B=16 x 2048,
     mixtral-8x22b's GQA (H=48, Hkv=8, dh=128, window 4096) there and at
     phase 14's B=16 x 2048, B=4 x 512 and B=1 x 43, whisper-small's
     heads (H = Hkv = 12, dh = 64) at phase 15's B=16: its encoder
     (non-causal, 1,500 x 1,500), cross-attention (non-causal, 384
     queries over 1,500 keys) and decoder (causal 384), and the
     shapes the main paths give it at llama3.2-1b width (phase 8's B=1
     forwards of 2-43 tokens, phase 6's B=4 x 512, the serve prefill's
     B=16 x 2048), within f32 2e-5 / bf16 2e-2; each
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
     design's own tensor work (1.5x the function's), and at
     recurrentgemma-9b's serve prefill (with SDPA given the window as a
     boolean mask, the kernel it ran named, and SDPA's causal path);
  8. the paper's MCTS with the LM as its simulation at full width, bf16:
     TreeParallelMCTS(X=256, F=6, D=4, p=16) over LMTreeEnv and
     LMContinuationBackend, two run_step() calls of at most 16
     supersteps (the second re-rooting), held superstep by superstep against the numpy oracle executor
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
     over a profiled window of 40 ticks; then four alternating pairs of
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
     (c) one pair of the stream, overlap against
     lock-step at K=1 (both with pool expansion), each held to its
     oracle, for the ratio of their speeds, searches/s, the
     service_overlap_busy_ratio gauges and the graph captures; (d) no
     env worker process initialised CUDA;
 12. the paper's Gomoku benchmark (b) at full width (X=48,000, F=36, D=5,
     PUCT, expand-all, p=16), the policy-value net (C=32, seeded random
     weights) as the Simulation: (a) the net on the card against the same
     net on the CPU (TF32 off) at B in {1, 16, 64, 256}, within 1e-5,
     NNSimBackend's rows bit-identical across those batch sizes and a
     permutation, its dispatch under CUDA's sync debug mode "error", two
     dispatches in flight each finalized with its own rows; (b)
     TreeParallelMCTS (cuda) held superstep by superstep to the numpy
     oracle on the same backend until the tree is full, each tree kernel
     once per superstep; (c) two run_step() calls (the second
     re-rooting), a profiled window of 20 supersteps (busy share, each
     tree kernel's device ms), the B=16 forward's device ms and the host
     ms of dispatch + finalize; (d) a 12-request stream through
     SearchClient (G=8) over CachedSimBackend(SimServer(max_batch=64)),
     equal to a numpy-oracle client's, cache off equal to cache on with
     cache hits, every forward 64 rows, K=8 equal to K=1; (e) the stream
     with overlap=True, two gangs, held to an overlap oracle, and two
     alternating overlap / lock-step pairs for the ratio of their speeds;
 13. the recurrent LM families at full width and depth: (a) mamba2-2.7b
     in an f32 copy (TF32 off), 4 prompts of 512 tokens prefilled by the
     chunked SSD scan and 32 greedy tokens decoded by the recurrence,
     every row within 2e-3 of the teacher-forced forward; (b) the serve
     entry point at mamba2-2.7b and recurrentgemma-9b, bf16, 16 prompts
     of 2,048 tokens then 64 tokens: prefill ms, decode tokens/s, peak
     memory, one flash launch per local-attention layer (12 for
     recurrentgemma, none for mamba2), and one SSD and one RG-LRU layer's
     prefill and decode step timed with their top kernels; (c)
     recurrentgemma-9b in an f32 copy, 4 prompts of 2,048 tokens: the
     flash prefill within 1e-3 of the blockwise prefill (argmax
     identical), then 32 decode tokens past the
     ring buffer's wrap, every row within 2e-3 of the teacher-forced
     forward; (d) TreeParallelMCTS(X=256, F=6, D=4, p=16) over LMTreeEnv
     and LMContinuationBackend(pool_size=16) at mamba2-2.7b, bf16, one
     run_step() of at most 16 supersteps held superstep by superstep to
     the numpy oracle
     replaying the recorded env steps and values, then where its
     superstep goes; (e) a ContinuousBatcher of 2 slots over both archs
     at SMOKE width, f32: every request's log-probs within 1e-4 of a
     fresh batcher's that serves it alone, and moved by more with the
     recurrent leaves' clearing patched out;
 14. the MoE and MLA families at full published width and cut depth
     (each line's `reduced` names the cut): (a) the MoE dispatch at
     mixtral's and deepseek-v3's E and K over the serve's 32,768 tokens,
     router probabilities on the card (f32, TF32 off), the dispatch on the
     card against the CPU's from the same probabilities, every integer
     identical, for the drawn router, its columns duplicated in pairs
     (exact ties) and a skewed one (pairs drop), with each expert's load
     and the dropped pairs; (b) mixtral-8x22b at 2 layers in an f32 copy,
     4 prompts of 512 tokens: the flash prefill within 1e-3 of blockwise,
     32 greedy decode tokens within 2e-3 of the teacher-forced forward on
     the prompts none of whose (token, expert) pairs dropped (at least
     one); (c) deepseek-v3-671b's 3 dense MLA layers in an f32 copy, one
     prompt of 2,048: the blockwise prefill within 1e-4 of naive, 16
     decode tokens through the decompressed and the absorbed latent
     cache, each within 2e-3 of the forward and of each other; (d)
     serve.serve at mixtral 8 layers and deepseek 3 dense + 2 MoE layers,
     bf16, 16 x 2,048 + 64: prefill ms, decode tokens/s, peak memory, the
     prefill's dropped share, 8 flash launches for mixtral and none for
     deepseek; (e) TreeParallelMCTS(X=256, F=6, D=4, p=16) over mixtral
     at 8 layers, one run_step() of at most 16 supersteps against the
     numpy oracle; (f) one MoE
     layer's prefill and decode step by part (router, dispatch, experts,
     combine, shared expert), one MLA layer's prefill and decode steps,
     and the flash kernel at mixtral's serve prefill against SDPA and its
     bound;
 15. the encoder and the VLM prefix at full published width and depth:
     (a) whisper-small in an f32 copy (TF32 off), 4 prompts of 384
     tokens over seeded frames (1,500): the flash prefill (36 launches:
     12 encoder layers, 12 self- and 12 cross-attentions) within 1e-3 of
     the naive prefill, 32 greedy decode tokens through the cross-KV
     cache within 2e-3 of the teacher-forced forward, the card's forward
     of one prompt within 1e-4 of the CPU's; (b) paligemma-3b in an f32
     copy, 2 prompts of 256 tokens behind 256 seeded patches: the
     blockwise prefix prefill within 1e-3 of naive, 16 decode tokens
     with serve's cache within 2e-3 of the forward, and the same tokens
     through the JAX launcher's cache size (without the prefix), which
     must move decode off the forward by more than 1e-2; (c) serve.serve
     at both, bf16 (whisper 16 x 384 + 64 over 1,500 frames, paligemma
     16 x (256 + 2,048) + 64): prefill ms, decode tokens/s, peak memory,
     the route, 36 and 0 flash launches, then one prefill and one
     decode step of each timed by part (host ms, device ms, busy share,
     top kernels); (d) the flash kernel at
     whisper's encoder (B=16, S=1,500) and cross-attention (B=16, 384
     over 1,500) shapes, non-causal, against blockwise, SDPA and its
     bound;
 16. training through the port's launcher (repro_torch.launch.train;
     plain torch under autograd: the training path runs none of the three
     kernels, and each row of the kernels line counts its launches there,
     0): (a) llama3.2-1b at its width with 2 layers in f32 (TF32 off), one
     seeded CPU init moved to the card, 3 train steps of B=2, S=64
     (naive, AdamW) on both, loss, nll and grad_norm within 1e-4
     relative at every step; (b) llama3.2-1b at full width and depth,
     20 steps of B=8, S=512, bf16, naive, AdamW: every loss finite, the
     parameters moved, ms a step (median after the first), tokens/s,
     peak memory, and one step under the profiler (busy share, top
     kernels); (c) restart-replay at 1 layer, B=2, S=64, bf16: 6 steps
     straight against 3 with --ckpt (a temp dir, removed) and a resume
     to 6, the final losses within 1e-4 (tests/test_checkpoint.py:89),
     and 6 steps with --compress; (d) deepseek-v3-671b's 3 dense MLA
     layers and its MTP block at published width, 5 steps of B=4, S=512,
     bf16, Adafactor: every loss, nll and mtp_nll finite, ms a step and
     peak; (e) impl="flash" under autograd raises before it launches;
 17. the launch tooling (launch/distributed_init.py, mesh.py,
     collectives.py, specs.py, roofline.py, dryrun.py; models/sharding.py,
     moe.py's shard-map path; distributed/checkpoint.py's restore onto a
     mesh): (a) a world of one on the card (NCCL on a free localhost
     port), a 1x1 (data, model) DeviceMesh, all_reduce / all_gather /
     broadcast of seeded bf16 and f32 tensors bit for bit with the
     recorder's bytes exact; (b) one MoE layer of mixtral-8x22b and of
     deepseek-v3-671b at full width (bf16, B=4 x 512) through the
     shard-map path on that mesh, y and aux identical to the dense path's,
     the model all-reduce's T * d * 2 bytes recorded; (c) a seeded tree
     (llama3.2-1b's f32 embedding among it) restored onto the mesh, every
     leaf a DTensor equal to the saved one bit for bit; (d) the dry run's
     op counts (meta tensors) of llama3.2-1b's train step at phase 16(b)'s
     shape and its serve prefill at phase 7's (flash through its 16
     reports), each bound against the time this run measured for it: the
     share and the MFU; (e) the dry run's state bytes of that train cell
     on a 1x1 mesh against the card's allocation after the launcher built
     the same state in 16(b), within 2%.

It prints JSON lines; the line before the last is {"kernels": [...]} and
the last is {"ok": true, "device": {...}}.  It imports nothing of the JAX
package.  With no CUDA device it exits 2 before printing any result.
"""

from __future__ import annotations

import dataclasses
import gc
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


T_START = time.perf_counter()


def emit(**kw):
    """One JSON line; "t" is the seconds since the script started."""
    print(json.dumps(dict(kw, t=round(time.perf_counter() - T_START, 1))),
          flush=True)


def progress(phase: int) -> None:
    """Name the phase that starts now on stderr, so that the end of a run
    cut by its time limit says where it was."""
    print(f"chip_smoke: phase {phase} starts at "
          f"{time.perf_counter() - T_START:.1f} s", file=sys.stderr, flush=True)


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
    ("recurrentgemma-9b", 16, 1, 256, (2048,)),
    ("mixtral-8x22b", 48, 8, 128, (4096,)),
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
MAMBA, RGEMMA = "mamba2-2.7b", "recurrentgemma-9b"
RG_WINDOW = 2048
# recurrentgemma-9b's local attention (MQA, dh=256, window 2048) at the
# serve prefill (phase 13) and phase 13's f32 prefill
RG_SHAPES = [(16, 2048, 2048, 16, 1, 256), (4, 2048, 2048, 16, 1, 256)]
RG_SERVE_HEADS = (16, 2048, 16, 1, 256)   # B, S, H, Hkv, dh
WHISPER, PALIGEMMA = "whisper-small", "paligemma-3b"
# whisper-small's heads (H = Hkv = 12, dh = 64) at phase 15's serve shape
# (16 x 384 tokens over 1,500 frames): (shape, causal) of its encoder, its
# cross-attention and its decoder's self-attention
WHISPER_SHAPES = [((16, 1500, 1500, 12, 12, 64), False),
                  ((16, 384, 1500, 12, 12, 64), False),
                  ((16, 384, 384, 12, 12, 64), True)]


def randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device=DEV).to(dtype)


def phase_flash() -> int:
    from repro_torch.kernels import flash_attention as FA

    # the f32 references state their matmul precision: TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=DEV).manual_seed(0)
    cases = [(s, w, None, True) for s in FLASH_SHAPES for w in (None, 64)]
    cases += [((1, 2048, 2048, H, Hkv, dh), w, arch, True)
              for arch, H, Hkv, dh, windows in FULL_WIDTH_HEADS for w in windows]
    cases += [(s, None, LLAMA + " main path", True) for s in MAIN_PATH_SHAPES]
    cases += [(s, RG_WINDOW, RGEMMA + " phase 13", True) for s in RG_SHAPES]
    cases += [(s, MIXTRAL_WINDOW, MIXTRAL + " phase 14", True)
              for s in MIXTRAL_SHAPES]
    cases += [(s, None, WHISPER + " phase 15", c) for s, c in WHISPER_SHAPES]
    bad, worst, n, worst_share = [], 0.0, 0, 0.0
    for shape, window, arch, causal in cases:
        B, Sq, Sk, H, Hkv, dh = shape
        for dtype, tol in FLASH_TOL.items():
            q = randn(gen, (B, Sq, H, dh), dtype)
            k, v = (randn(gen, (B, Sk, Hkv, dh), dtype) for _ in range(2))
            out = FA.flash_attention(q, k, v, causal=causal,
                                     window=window).float()
            ref = FA.flash_attention_plain(q, k, v, causal=causal,
                                           window=window).float()
            torch.cuda.synchronize()
            err = (out - ref).abs()
            ok = bool((err <= tol + tol * ref.abs()).all())
            e = float(err.max())
            row = dict(max_abs_err=e, tol=tol)
            del ref
            if dtype == torch.bfloat16:
                wide = FA.flash_attention_plain(q.float(), k.float(), v.float(),
                                                causal=causal, window=window)
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
                 causal=causal, dtype=str(dtype).split(".")[-1], ok=ok, **row)
            if not ok:
                bad.append((shape, window, causal, str(dtype)))
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
    return launches, 1e3 * out["prefill_s"]


PHASE8_HEADS = (1, 43, 32, 8, 64)   # phase 8's longest B=1 forward


def flash_timing(shape, seed, window=None, kv_len=None, causal=True) -> dict:
    """The flash kernel at one bf16 shape (B, S, H, Hkv, dh): causal, with
    an optional sliding window, or with causal=False every query of S
    over kv_len (default S) keys: ms per launch from CUDA events and
    device ms from the profiler, against the plain version (blockwise),
    scaled_dot_product_attention (with the window as a boolean mask where
    there is one, and the name of the kernel it ran, which names its
    backend) and the bound (the function's work).  Its flash_row line adds
    the bytes and operations and the floor of the split-P design's tensor
    work (1.5x the function's); the returned row, which goes on the
    kernels line, holds the measured times and the bound only."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models.attention import blockwise_attention

    B, S, H, Hkv, dh = shape
    Sk = kv_len or S
    gen = torch.Generator(device=DEV).manual_seed(seed)
    q = randn(gen, (B, S, H, dh), torch.bfloat16)
    k, v = (randn(gen, (B, Sk, Hkv, dh), torch.bfloat16) for _ in range(2))
    none = lambda: None
    run = lambda: FA.flash_attention(q, k, v, causal=causal, window=window)
    n0 = FA.launches
    ms = cuda_time_ms(run, none, 20)
    dev = device_ms(run, none, 10, "flash_fwd_wgmma")
    FA.launches = n0
    plain = cuda_time_ms(lambda: blockwise_attention(q, k, v, causal=causal,
                                                     window=window),
                         none, 3, warm=1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    pos = torch.arange(S, device=DEV)
    mask = None
    if window is not None:
        mask = ((pos[None, :] <= pos[:, None])
                & (pos[None, :] > pos[:, None] - window))
    sdpa = lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=True)
    lib = cuda_time_ms(sdpa, none, 20)
    lib_trace = wall_and_device_ms(sdpa, 10)
    ops, nbytes = FA.costs(q, k, v, causal=causal, window=window)
    t_ops = 1e3 * ops / H100_BF16_OPS_PER_S
    t_bytes = 1e3 * nbytes / H100_HBM_BYTES_PER_S
    split_floor = 1.5 * t_ops
    row = dict(ms=ms, device_ms=dev, plain_ms=plain, library_ms=lib,
               library_device_ms=lib_trace["device_ms"],
               library_kernel=lib_trace["top"][0][0] if lib_trace["top"] else None,
               bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               shape=f"B={B} S={S} H={H} Hkv={Hkv} dh={dh} bf16 "
                     + ("causal" if causal else f"non-causal Sk={Sk}")
                     + (f" window={window}" if window else ""))
    if mask is not None:     # the window covers S here: SDPA's causal path
        row["library_causal_ms"] = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), none, 20)
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
        at_phase8_shape=flash_timing(PHASE8_HEADS, 3),
        at_recurrentgemma_serve=flash_timing(RG_SERVE_HEADS, 4, window=RG_WINDOW))


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


def attn_layers(cfg) -> int:
    return sum(spec.kind == "attn" for spec in cfg.layer_specs())


MCTS_LM_SUPERSTEPS = 16     # a run_step()'s cap in phases 8, 13 and 14


def phase_mcts_lm(cfg, reuses=(False, True)):
    """TreeParallelMCTS (cuda) over LMTreeEnv + LMContinuationBackend at
    cfg (full width, depth as given), bf16, one run_step() of at most
    MCTS_LM_SUPERSTEPS supersteps per entry of `reuses`, held superstep by
    superstep to the numpy oracle replaying the recorded env steps and
    values.  Returns the kernels' launches."""
    from repro_torch.core import TreeConfig, TreeParallelMCTS
    from repro_torch.core.mcts import StepStats
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import uct_backup, uct_select
    from repro_torch.models import lm
    from repro_torch.obs import MetricsRegistry
    from repro_torch.sim import LMContinuationBackend, LMTreeEnv

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
    for reuse in reuses:
        mc.stats = StepStats()
        t1 = time.perf_counter()
        a, _, _ = mc.run_step(MCTS_LM_SUPERSTEPS, reuse_subtree=reuse)
        wall = time.perf_counter() - t1
        s, n = mc.stats, max(mc.stats.supersteps, 1)
        tok = int(mc.env.env.tokens(mc.root_state)[-1])
        moves.append(int(a))
        emit(phase="mcts_lm", arch=cfg.name, reuse_subtree=reuse,
             action=int(a), token=tok,
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
    ref_moves = [int(mr.run_step(MCTS_LM_SUPERSTEPS, reuse_subtree=reuse)[0])
                 for reuse in reuses]
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
    if launches["flash_attention"] != attn_layers(cfg) * forwards:
        raise AssertionError(f"flash launched {launches['flash_attention']} "
                             f"times for {forwards} full forwards")
    for name in ("uct_select", "uct_backup"):
        if launches[name] != steps or steps == 0:
            raise AssertionError(f"{name} launched {launches[name]} times in "
                                 f"{steps} supersteps")
    emit(phase="mcts_lm", arch=cfg.name, layers=cfg.n_layers, identical=True,
         supersteps=steps,
         moves=moves,
         tokens=mc.env.env.tokens(mc.root_state).tolist(), launches=launches,
         full_forwards=forwards, env_steps=env.steps, admissions=admitted,
         one_token_admissions=one_token,
         decode_steps=sim.sim.batcher.decode_steps, wall_s=wall,
         supersteps_per_s=steps / wall)
    phase_lm_costs(cfg, params, env.env, mc.root_state)
    return launches


PROFILED_CALLS = 2   # key_averages() takes the host ~0.3 ms an event


def wall_and_device_ms(fn, n: int) -> dict:
    """ms per call of fn on the host's clock over n calls (ending in a
    synchronize), and the device time of all its kernels per call from
    torch.profiler over min(n, PROFILED_CALLS) calls (summed over the
    device-side events only: a CPU op's device time repeats its
    kernels'), so busy = device / wall; `top` lists the five kernels with
    the most device time per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0) / n
    m = min(n, PROFILED_CALLS)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(m):
            fn()
        torch.cuda.synchronize()
    self_ms = sorted(((getattr(e, "self_device_time_total", None)
                       or getattr(e, "self_cuda_time_total", 0.0)) / 1e3 / m,
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
    emit(phase="lm_costs", arch=cfg.name, state_len=int(state[0]), **host,
         **out)


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
FUSED_PAIRS = 4     # alternating K=1 / K=8 stream pairs for the ratio


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
OVERLAP_PAIRS = 1   # alternating overlap / lock-step stream pairs


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


# ---------------------------------------------------------------------------
# phase 12: the paper's Gomoku benchmark (b), the policy-value net as the
# Simulation backend, at full width
# ---------------------------------------------------------------------------

GOMOKU_C, GOMOKU_P, GOMOKU_G = 32, 16, 8
NN_BATCHES = (1, 16, 64, 256)
NN_TOL = 1e-5            # card vs CPU, f32 with TF32 off
NN_MAX_BATCH, NN_CACHE = 64, 8192
GOMOKU_REQUESTS, GOMOKU_PAIRS = 12, 2
GOMOKU_WINDOW = 20       # supersteps under the profiler


def gomoku_states(n: int, seed: int) -> np.ndarray:
    """n Gomoku states from seeded random playouts; terminal rows kept."""
    from repro_torch.envs import GomokuEnv

    env, rng, out = GomokuEnv(), np.random.default_rng(seed), []
    while len(out) < n:
        s = env.initial_state(0)
        for _ in range(int(rng.integers(0, 41))):
            if env.num_actions(s) == 0:
                break
            s, _, _ = env.step(s, int(rng.integers(env.num_actions(s))))
        out.append(s)
    return np.stack(out)


def gomoku_params() -> dict:
    from repro_torch.envs.policy_net import init_params

    return init_params(torch.Generator().manual_seed(0), channels=GOMOKU_C)


def counting_nn(params, device=None):
    """An NNSimBackend that records the row count of every dispatch."""
    from repro_torch.envs import GomokuEnv
    from repro_torch.envs.policy_net import NNSimBackend

    class CountingNN(NNSimBackend):
        def dispatch(self, states):
            self.rows.append(len(states))
            return super().dispatch(states)

    be = CountingNN(GomokuEnv(), params, device=DEV if device is None else device)
    be.rows = []
    return be


def nn_checks(params) -> dict:
    """(a) The net on the card against the same net on the CPU (TF32 off)
    at B in NN_BATCHES, within NN_TOL; the backend's rows bit-identical
    across those batch sizes and a permutation; the card backend against
    the CPU backend (terminal values exactly); a dispatch under CUDA's
    sync debug mode "error"; two dispatches in flight, each finalized
    with its own rows."""
    from repro_torch.envs.policy_net import (
        PolicyValueNet, canonical_boards, exact_f32,
    )

    states = gomoku_states(max(NN_BATCHES), 0)
    term = states[:, 1] != 0
    boards = torch.from_numpy(canonical_boards(states)).view(-1, 6, 6)
    cpu_net, card_net = PolicyValueNet(params), PolicyValueNet(params).to(DEV)
    err = {"values": 0.0, "logits": 0.0}
    raw = {}
    with exact_f32(), torch.no_grad():
        cv, cl = cpu_net(boards)
        for B in NN_BATCHES:
            v, lg = (t.cpu() for t in card_net(boards[:B].to(DEV)))
            err["values"] = max(err["values"], float((v - cv[:B]).abs().max()))
            err["logits"] = max(err["logits"], float((lg - cl[:B]).abs().max()))
            raw[B] = (v, lg)
    top = max(NN_BATCHES)
    raw_rows_same = all(torch.equal(raw[B][0], raw[top][0][:B])
                        and torch.equal(raw[B][1], raw[top][1][:B])
                        for B in NN_BATCHES)
    be, cpu_be = counting_nn(params), counting_nn(params, device="cpu")
    fv, fp = be.evaluate(states)
    rows_same = all(np.array_equal(v, fv[:B]) and np.array_equal(pr, fp[:B])
                    for B in NN_BATCHES for v, pr in [be.evaluate(states[:B])])
    perm = np.random.default_rng(1).permutation(top)
    pv, pp = be.evaluate(states[perm])
    rows_same = rows_same and np.array_equal(pv, fv[perm]) \
        and np.array_equal(pp, fp[perm])
    cpv, cpp = cpu_be.evaluate(states)
    backend_err = max(float(np.abs(fv - cpv).max()), float(np.abs(fp - cpp).max()))

    a, b = states[:16], states[16:80]
    for _ in range(2):       # both in-flight stagings allocated before
        ta, tb = be.dispatch(a), be.dispatch(b)
        be.finalize(tb, b), be.finalize(ta, a)
    torch.cuda.synchronize()
    with sync_errors():
        ta, tb = be.dispatch(a), be.dispatch(b)
    vb, pb = be.finalize(tb, b)
    va, pa = be.finalize(ta, a)
    checks = {
        "card_vs_cpu_within_tol": max(err.values()) <= NN_TOL,
        "backend_card_vs_cpu_within_tol": backend_err <= NN_TOL,
        "terminal_values_exact": bool(np.array_equal(fv[term], cpv[term])),
        "rows_independent_of_batch": bool(rows_same),
        "in_flight_rows_own": bool(
            np.array_equal(va, fv[:16]) and np.array_equal(pa, fp[:16])
            and np.array_equal(vb, fv[16:80]) and np.array_equal(pb, fp[16:80])),
    }
    out = dict(channels=GOMOKU_C, batches=list(NN_BATCHES),
               terminal_rows=int(term.sum()), tol=NN_TOL,
               max_abs_err=max(err.values()), max_abs_err_values=err["values"],
               max_abs_err_logits=err["logits"],
               backend_max_abs_err=backend_err,
               raw_net_rows_batch_independent=raw_rows_same,
               dispatch_sync_free=True, checks=checks)
    emit(phase="gomoku_nn", **out)
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"gomoku net checks failed: {bad} ({err}, "
                             f"backend {backend_err})")
    return out


def gomoku_mcts(executor: str, sim):
    from repro_torch.configs.gomoku_cfg import TREE
    from repro_torch.core import TreeParallelMCTS
    from repro_torch.envs import GomokuEnv

    return TreeParallelMCTS(TREE, GomokuEnv(), sim, p=GOMOKU_P,
                            executor=executor, alternating_signs=True,
                            expansion="vector", device=DEV)


def gomoku_main_path(params) -> dict:
    """(b) TreeParallelMCTS at the Gomoku width on the cuda executor, held
    superstep by superstep to the numpy oracle on the same backend until
    the tree holds X nodes (or a superstep adds none: an expand-all
    needs room for every child): every selection and the final tree
    identical, each tree kernel once per superstep."""
    from repro_torch.kernels import uct_backup, uct_select

    sim = counting_nn(params)
    mc, mr = gomoku_mcts("cuda", sim), gomoku_mcts("reference", sim)
    steps, t_cuda, t_ref = 0, 0.0, 0.0
    uct_select.launches = uct_backup.launches = 0
    while mc._size() < mc.cfg.X:
        size = mc._size()
        t0 = time.perf_counter()
        a = mc.superstep()
        t1 = time.perf_counter()
        b = mr.superstep()
        t_cuda += t1 - t0
        t_ref += time.perf_counter() - t1
        for k in b:
            if not np.array_equal(a[k], b[k]):
                raise AssertionError(f"gomoku superstep {steps}: {k} differs "
                                     f"from the numpy oracle")
        steps += 1
        if mc._size() == size:
            break
    launches = {"uct_select": uct_select.launches,
                "uct_backup": uct_backup.launches}
    sc, sr = mc.exec.snapshot(mc.tree), mr.exec.snapshot(mr.tree)
    diff = [k for k in sr if not np.array_equal(sc[k], sr[k])]
    if diff:
        raise AssertionError(f"gomoku final tree differs from the oracle in {diff}")
    for name, n in launches.items():
        if n != steps:
            raise AssertionError(f"{name} launched {n} times in {steps} "
                                 f"gomoku supersteps")
    if not sc["edge_P"].any():
        raise AssertionError("no prior reached the gomoku tree")
    out = dict(X=mc.cfg.X, F=mc.cfg.F, D=mc.cfg.D, p=GOMOKU_P, C=GOMOKU_C,
               supersteps=steps, tree_size=int(sc["size"]), identical=True,
               launches=launches, nn_forwards=len(sim.rows),
               cuda_s=t_cuda, reference_s=t_ref)
    emit(phase="gomoku_main_path", **out)
    return out


def gomoku_timed(params) -> dict:
    """(c) Two run_step() calls (the second re-rooting): ms per superstep
    by phase and supersteps/s; a profiled window of GOMOKU_WINDOW
    supersteps (device busy share, device ms per launch of each tree
    kernel and of the net's forward); the NN forward at B=16 (device ms
    of its kernels, host ms of dispatch + finalize)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.envs.policy_net import canonical_boards
    from repro_torch.kernels import uct_backup, uct_select

    sim = counting_nn(params)
    m = gomoku_mcts("cuda", sim)
    uct_select.launches = uct_backup.launches = 0
    rows = []
    for reuse in (False, True):
        m.stats = type(m.stats)()
        t0 = time.perf_counter()
        a, _, _ = m.run_step(reuse_subtree=reuse)
        wall = time.perf_counter() - t0
        s = m.stats
        n = max(s.supersteps, 1)
        row = dict(reuse_subtree=reuse, action=int(a), supersteps=s.supersteps,
                   wall_s=wall, supersteps_per_s=s.supersteps / wall,
                   ms_per_superstep={k: 1e3 * getattr(s, "t_" + k) / n for k in (
                       "select", "insert", "st", "sim", "transfer", "backup",
                       "intree", "total")})
        emit(phase="gomoku_run_step", **row)
        rows.append(row)
    launches = {"uct_select": uct_select.launches,
                "uct_backup": uct_backup.launches}
    steps = sum(r["supersteps"] for r in rows)
    if any(n != steps for n in launches.values()):
        raise AssertionError(f"gomoku run_step launches {launches} in {steps} "
                             f"supersteps")

    w = gomoku_mcts("cuda", sim)
    for _ in range(5):
        w.superstep()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(GOMOKU_WINDOW):
            w.superstep()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    union_ms, evs, names = device_intervals_ms(prof)
    per_kernel = {}
    for e in evs:
        for key in ("uct_select_kernel", "uct_backup_kernel"):
            if key in e.name:
                per_kernel.setdefault(key, []).append(
                    (e.time_range.end - e.time_range.start) / 1e3)
    window = dict(supersteps=GOMOKU_WINDOW, wall_ms=wall,
                  device_busy_ms=union_ms, busy=union_ms / wall,
                  device_events=len(evs),
                  kernel_device_ms={k: float(np.mean(v))
                                    for k, v in per_kernel.items()},
                  kernel_launches={k: len(v) for k, v in per_kernel.items()})

    states = gomoku_states(16, 3)
    be = counting_nn(params)
    up = torch.from_numpy(be.padded(canonical_boards(states))).to(DEV)
    fwd = wall_and_device_ms(lambda: be.forward_rows(up), 50)
    be.evaluate(states)
    t = {"dispatch": 0.0, "finalize": 0.0}
    n = 50
    for _ in range(n):
        t0 = time.perf_counter()
        tok = be.dispatch(states)
        t1 = time.perf_counter()
        be.finalize(tok, states)
        t2 = time.perf_counter()
        t["dispatch"] += t1 - t0
        t["finalize"] += t2 - t1
    nn = dict(rows=16, padded_rows=int(up.shape[0]), forward=fwd,
              host_ms={k: 1e3 * v / n for k, v in t.items()},
              host_ms_dispatch_finalize=1e3 * sum(t.values()) / n)
    out = dict(run_step=rows, launches=launches, window=window, nn_forward=nn)
    emit(phase="gomoku_timed", launches=launches, window=window, nn_forward=nn)
    return out


def gomoku_stream(seed: int = 0) -> list:
    """GOMOKU_REQUESTS seeded requests: budgets 16-48 supersteps a move,
    1-2 moves, every fourth keeps its tree."""
    rng = np.random.RandomState(seed)
    return [dict(uid=i, seed=int(rng.randint(1 << 20)),
                 budget=int(rng.randint(16, 49)), moves=int(rng.randint(1, 3)),
                 keep_tree=i % 4 == 0) for i in range(GOMOKU_REQUESTS)]


def gomoku_run(stream, params, executor="cuda", cache=True, **kw) -> dict:
    """The stream through SearchClient(GomokuEnv(), CachedSimBackend(
    SimServer(NNSimBackend), NN_CACHE) (cache=False: the SimServer
    alone), G=GOMOKU_G, p=GOMOKU_P, the Gomoku TREE, alternating signs,
    vector expansion); kw adds to or overrides the client's settings.
    Returns the results, the wall, the stats, the launches, the metrics
    snapshot and the row count of every forward."""
    from repro_torch.configs.gomoku_cfg import TREE
    from repro_torch.envs import GomokuEnv
    from repro_torch.kernels import uct_backup, uct_select
    from repro_torch.service import SearchClient, SearchRequest
    from repro_torch.sim import CachedSimBackend, SimServer

    nn = counting_nn(params)
    sim = SimServer(nn, max_batch=NN_MAX_BATCH)
    if cache:
        sim = CachedSimBackend(sim, capacity=NN_CACHE)
    uct_select.launches = uct_backup.launches = 0
    opts = dict(expansion="vector", metrics=True)
    opts.update(kw)
    cl = SearchClient(GomokuEnv(), sim_backend=sim, executor=executor,
                      G=GOMOKU_G, p=GOMOKU_P, default_cfg=TREE,
                      alternating_signs=True, device=DEV, **opts)
    try:
        t0 = time.perf_counter()
        hs = [cl.submit(SearchRequest(**r)) for r in stream]
        got = {h.uid: h.result() for h in hs}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        snap = cl.registry.snapshot()
        stats, ticks = cl.stats, cl.core.ticks
    finally:
        cl.close()
    return {"got": got, "wall": wall, "stats": stats, "ticks": ticks,
            "launches": {"uct_select": uct_select.launches,
                         "uct_backup": uct_backup.launches},
            "metrics": {k: v for k, v in snap.items()
                        if k.startswith(("sim_server", "sim_cache",
                                         "service_overlap_busy_ratio"))},
            "rows": nn.rows}


def gomoku_serving(params) -> dict:
    """(d) The stream on the cuda executor with SimServer and the cache,
    held to a numpy-oracle client with the same sim stack; cache off
    equal to cache on, with cache hits; every forward exactly
    NN_MAX_BATCH rows; supersteps_per_dispatch=8 equal to K=1 (expand-all
    is refused by the fused dispatch, so it runs the phase path)."""
    stream = gomoku_stream()
    on = gomoku_run(stream, params)
    ref = gomoku_run(stream, params, executor="reference")
    n = results_identical(on["got"], ref["got"], "gomoku cuda vs the numpy oracle")
    off = gomoku_run(stream, params, cache=False)
    results_identical(off["got"], on["got"], "gomoku cache off vs cache on")
    k8 = gomoku_run(stream, params, supersteps_per_dispatch=8)
    results_identical(k8["got"], on["got"], "gomoku K=8 vs K=1")
    st = on["stats"]
    hits = sum(on["metrics"].get("sim_cache_hits_total", {}).values())
    checks = {
        "cache_hits": hits > 0,
        "forwards_full_width": all(r == NN_MAX_BATCH for run in (on, off, k8)
                                   for r in run["rows"]),
        "launches_per_pool_tick": all(v == st.supersteps
                                      for v in on["launches"].values()),
        "k8_phase_path": k8["stats"].fused_dispatches == 0,
    }
    out = dict(G=GOMOKU_G, p=GOMOKU_P, requests=n, identical=True,
               checks=checks, wall_s=on["wall"], searches_per_s=n / on["wall"],
               wall_s_cache_off=off["wall"], wall_s_k8=k8["wall"],
               reference_s=ref["wall"], ticks=on["ticks"],
               pool_supersteps=st.supersteps, launches=on["launches"],
               ms_per_tick={k: 1e3 * getattr(st, "t_" + k) / max(on["ticks"], 1)
                            for k in ("intree", "expand", "host", "sim")},
               forwards=len(on["rows"]), forwards_cache_off=len(off["rows"]),
               metrics=on["metrics"], metrics_cache_off=off["metrics"])
    emit(phase="gomoku_serving", **out)
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"gomoku serving checks failed: {bad}")
    return {"want": ref["got"], "launches": on["launches"], "stream": stream}


def gomoku_overlap(params, stream, want) -> dict:
    """(e) The stream with overlap=True, n_gangs=2 (K=1, vector expansion)
    held to a numpy-oracle client with the same overlap settings (and
    to the lock-step oracle); GOMOKU_PAIRS alternating pairs, overlap
    against lock-step, each held to its oracle: the median speed ratio
    (lock-step wall over overlap wall), its range, the busy-ratio
    gauges."""
    ov = dict(overlap=True, n_gangs=2)
    want_ov = gomoku_run(stream, params, executor="reference", **ov)["got"]
    results_identical(want_ov, want, "gomoku overlap oracle vs lock-step oracle")
    walls = {"overlap": [], "lockstep": []}
    gauges, launches = [], None
    for i in range(GOMOKU_PAIRS):
        order = (("overlap", ov), ("lockstep", {}))
        for mode, kw in (order if i % 2 == 0 else order[::-1]):
            r = gomoku_run(stream, params, **kw)
            results_identical(r["got"], want_ov if mode == "overlap" else want,
                              f"gomoku {mode} vs its oracle")
            walls[mode].append(r["wall"])
            if mode == "overlap":
                gauges.append(r["metrics"].get("service_overlap_busy_ratio", {}))
                launches = r["launches"]
    ratio = [a / b for a, b in zip(walls["lockstep"], walls["overlap"])]
    n = len(want)
    out = {"pairs": GOMOKU_PAIRS, "wall_s": walls,
           "searches_per_s": {k: [n / w for w in v] for k, v in walls.items()},
           "speed_ratio_overlap_over_lockstep": ratio,
           "median_ratio": float(np.median(ratio)), "min_ratio": min(ratio),
           "max_ratio": max(ratio), "busy_ratio": gauges,
           "launches_overlap": launches}
    emit(phase="gomoku_overlap", **out)
    return out


def phase_gomoku() -> dict:
    """Phase 12: the paper's Gomoku benchmark (b) at full width. Returns
    the tree kernels' launches and device ms on its paths."""
    t_phase = time.perf_counter()
    params = gomoku_params()
    nn_checks(params)
    main = gomoku_main_path(params)
    timed = gomoku_timed(params)
    serving = gomoku_serving(params)
    overlap = gomoku_overlap(params, serving["stream"], serving["want"])
    emit(phase="gomoku", seconds=time.perf_counter() - t_phase)
    return {"main": main["launches"], "run_step": timed["launches"],
            "serving": serving["launches"],
            "overlap": overlap["launches_overlap"],
            "device_ms": timed["window"]["kernel_device_ms"]}


# ---------------------------------------------------------------------------
# phase 13: the recurrent LM families (mamba2-2.7b SSD, recurrentgemma-9b)
# ---------------------------------------------------------------------------

DECODE_TOL = 2e-3     # tests/test_models_smoke.py:140-160: decode vs forward
PREFILL_TOL = 1e-3    # phase 6's bound: flash vs blockwise prefill, f32
REUSE_TOL = 1e-4      # a reused slot's log-probs against a fresh batcher's
RECURRENT_SERVE = dict(batch=16, prefill=2048, tokens=64)


def decode_rows(cfg, params, tokens, n_new, impl, **inputs):
    """Prefill `tokens` (with inputs: frames or patches) with `impl`, then
    n_new greedy decode steps, the caches sized as serve sizes them;
    returns (the prefill's and each step's logits [B, n_new + 1, V], the
    prompt and the generated tokens [B, S + n_new])."""
    from repro_torch.models import lm, steps

    B, S = tokens.shape
    caches = lm.init_caches(cfg, B, cfg.vlm_patches + S + n_new + 8, DEV)
    lg, caches = steps.make_prefill_step(cfg, impl=impl)(params, tokens, caches,
                                                         **inputs)
    decode = steps.make_decode_step(cfg, impl=impl)
    rows, seq = [lg], [tokens]
    positions = torch.arange(S, S + n_new, device=DEV)
    for i in range(n_new):
        seq.append(torch.argmax(rows[-1], -1)[:, None])
        lg, caches = decode(params, caches, seq[-1], positions[i])
        rows.append(lg)
    return torch.stack(rows, 1), torch.cat(seq, 1)


def forward_rows(cfg, params, seq, start: int, impl, **inputs):
    """The teacher-forced full forward over seq (with inputs: frames or
    patches), unembedded from row `start` on (no [B, S, V] tensor)."""
    from repro_torch.models import layers as L
    from repro_torch.models import lm

    x, _ = lm.hidden_states(cfg, params, seq, impl=impl, **inputs)
    return L.unembed(cfg, params["embed"], x[:, start:])


def against_forward(label, cfg, got, want, tol) -> dict:
    """Each row of got within tol (atol and rtol) of want's, or raise."""
    d = (got - want).abs()
    share = float((d / (tol + tol * want.abs())).max())
    out = dict(max_abs_logit_diff=float(d.max()),
               prefill_row_max_abs_diff=float(d[:, 0].max()),
               tol=tol, worst_tol_share=share,
               argmax_agreement=float((got.argmax(-1) == want.argmax(-1))
                                      .float().mean()))
    if not bool(torch.isfinite(got).all()) or share > 1.0:
        raise AssertionError(f"{label} {cfg.name}: decode rows differ from the "
                             f"teacher-forced forward: {out}")
    return out


def recurrent_decode():
    """(a) mamba2-2.7b at full width in an f32 copy (TF32 off): 4 prompts
    of 512 tokens prefilled (the chunked scan), 32 greedy decode tokens
    (the recurrence); the prefill's last logits and every step's against
    the teacher-forced forward, within 2e-3."""
    from repro_torch import configs
    from repro_torch.models import lm

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(configs.get_config(MAMBA), dtype="float32")
    params = lm.init_params(cfg, torch.Generator(device=DEV).manual_seed(0), DEV)
    tokens = torch.randint(0, cfg.vocab, (4, 512), device=DEV,
                           generator=torch.Generator(device=DEV).manual_seed(1))
    t0 = time.perf_counter()
    got, seq = decode_rows(cfg, params, tokens, 32, "blockwise")
    want = forward_rows(cfg, params, seq, 511, "blockwise")
    check = against_forward("(a)", cfg, got, want, DECODE_TOL)
    emit(phase="recurrent_decode", arch=cfg.name, dtype="float32", tf32=False,
         batch=4, prompt=512, decode_tokens=32, **check,
         seconds=time.perf_counter() - t0)
    del params


def recurrent_serve() -> dict:
    """(b) the serve entry point at both archs, bf16, 16 prompts of 2,048
    tokens then 64 decode tokens (a warm run, then the timed one): prefill
    ms, decode tokens/s, peak memory, and the flash kernel's launches in
    the timed run (one per local-attention layer)."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import serve

    launches = {}
    for arch in (MAMBA, RGEMMA):
        cfg = configs.get_config(arch)
        argv = ["--arch", arch] + [f"--{k}={v}" for k, v in RECURRENT_SERVE.items()]
        B, T = RECURRENT_SERVE["batch"], RECURRENT_SERVE["tokens"]
        serve.main(argv)                   # warm: cuBLAS, allocator
        FA.launches = 0
        out = serve.main(argv)
        launches[arch] = FA.launches
        toks = out["tokens"]
        if launches[arch] != attn_layers(cfg):
            raise AssertionError(f"{arch}: serve prefill launched flash "
                                 f"{launches[arch]} times, not "
                                 f"{attn_layers(cfg)}")
        if toks.shape != (B, T + 1) or toks.min() < 0 \
                or toks.max() >= cfg.padded_vocab:
            raise AssertionError(f"{arch}: serve tokens out of shape or range")
        emit(phase="recurrent_serve", arch=cfg.name, argv=" ".join(argv),
             device=out["device"], prefill_ms=1e3 * out["prefill_s"],
             decode_tokens_per_s=B * T / out["decode_s"],
             req_per_s=out["req_per_s"], peak_gib=out["peak_bytes"] / 2**30,
             flash_launches=launches[arch], attn_layers=attn_layers(cfg))
    return launches


def recurrent_layer_costs():
    """Where (b)'s time goes: one SSD layer's mixer (mamba2-2.7b) and one
    RG-LRU layer's mixer (recurrentgemma-9b), bf16 random weights, at the
    serve prefill's shape (16 x 2,048) and for one decode step from its
    cache: ms per call on the host's clock, device ms, busy share and the
    top kernels (torch.profiler)."""
    from repro_torch import configs
    from repro_torch.models import layers as L
    from repro_torch.models import rglru, ssd

    for arch, mixer, init, init_cache, fwd in (
            (MAMBA, "ssd", ssd.init_ssd, ssd.init_ssd_cache, ssd.ssd_forward),
            (RGEMMA, "rglru", rglru.init_rglru, rglru.init_rglru_cache,
             rglru.rglru_forward)):
        cfg = configs.get_config(arch)
        p = init(cfg, torch.Generator(device=DEV).manual_seed(0))
        gen = torch.Generator(device=DEV).manual_seed(1)
        B, S = RECURRENT_SERVE["batch"], RECURRENT_SERVE["prefill"]
        u = randn(gen, (B, S, cfg.d_model), L.dt(cfg))
        cache = init_cache(cfg, B, DEV)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        prefill = wall_and_device_ms(lambda: fwd(cfg, p, u, None), 3)
        transient = (torch.cuda.max_memory_allocated() - base) / 2**30
        decode = wall_and_device_ms(lambda: fwd(cfg, p, u[:, :1], cache), 10)
        emit(phase="recurrent_layer", arch=cfg.name, mixer=mixer,
             shape=f"B={B} S={S} {cfg.dtype}", prefill=prefill,
             prefill_transient_gib=transient, decode_step=decode)
        del p, u, cache


def recurrent_prefill() -> int:
    """(c) recurrentgemma-9b at full width and depth in an f32 copy (TF32
    off), 4 prompts of 2,048 tokens (the window's length): the flash
    prefill's last logits against the blockwise prefill's within 1e-3,
    then 32 decode tokens past the window's edge (the ring buffer wraps)
    and every row against the teacher-forced forward within 2e-3.
    Returns the flash launches of the flash prefill."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import lm, steps

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(configs.get_config(RGEMMA), dtype="float32")
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(cfg, torch.Generator(device=DEV).manual_seed(0), DEV)
    tokens = torch.randint(0, cfg.vocab, (4, 2048), device=DEV,
                           generator=torch.Generator(device=DEV).manual_seed(1))
    t0 = time.perf_counter()
    FA.launches = 0
    got, seq = decode_rows(cfg, params, tokens, 32, "flash")
    launches = FA.launches
    caches = lm.init_caches(cfg, 4, 2048 + 8, DEV)
    lb, _ = steps.make_prefill_step(cfg, impl="blockwise")(params, tokens, caches)
    del caches
    d = float((got[:, 0] - lb).abs().max())
    agree = float((got[:, 0].argmax(-1) == lb.argmax(-1)).float().mean())
    want = forward_rows(cfg, params, seq, 2047, "blockwise")
    check = against_forward("(c)", cfg, got, want, DECODE_TOL)
    emit(phase="recurrent_prefill", arch=cfg.name, dtype="float32", tf32=False,
         batch=4, prompt=2048, depth=cfg.n_layers, flash_launches=launches,
         flash_vs_blockwise_max_abs_diff=d, flash_vs_blockwise_argmax=agree,
         decode_tokens=32, decode_vs_forward=check,
         peak_gib=torch.cuda.max_memory_allocated() / 2**30,
         seconds=time.perf_counter() - t0)
    if launches != attn_layers(cfg):
        raise AssertionError(f"flash launched {launches} times in one prefill "
                             f"of {attn_layers(cfg)} attention layers")
    if d > PREFILL_TOL or agree != 1.0:
        raise AssertionError(f"f32 flash prefill differs from blockwise: max "
                             f"|d logits| {d}, argmax agreement {agree}")
    del params
    return launches


def slot_reuse():
    """(e) a ContinuousBatcher of 2 slots over both archs at SMOKE width,
    f32 with TF32 off, 8 requests: each request's log-probs within 1e-4
    of a fresh batcher's that serves it alone; with the recurrent leaves'
    clearing patched out, the reused slots' log-probs move by more."""
    from repro_torch import configs
    from repro_torch.envs.policy_net import exact_f32
    from repro_torch.models import lm
    from repro_torch.serving import ContinuousBatcher, Request
    from repro_torch.serving import batcher

    for arch in (MAMBA, RGEMMA):
        cfg = configs.get_config(arch, smoke=True)
        params = lm.init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                                DEV)
        rng = np.random.RandomState(9)
        prompts = [rng.randint(1, cfg.vocab, size=2 + 3 * i % 7).astype(np.int32)
                   for i in range(8)]

        def serve(batch):
            b = ContinuousBatcher(cfg, params, pool_size=2, max_seq=48,
                                  impl="flash", record_logprobs=True)
            for i, p in batch:
                b.submit(Request(uid=i, prompt=p, max_new_tokens=5))
            return {r.uid: np.asarray(r.logprobs) for r in b.run(max_steps=400)}

        with exact_f32():
            pooled = serve(list(enumerate(prompts)))
            alone = {i: serve([(i, p)])[i] for i, p in enumerate(prompts)}
            clear = batcher._clear_recurrent
            batcher._clear_recurrent = lambda row: None
            try:
                dirty = serve(list(enumerate(prompts)))
            finally:
                batcher._clear_recurrent = clear
        worst = max(float(np.abs(pooled[i] - alone[i]).max()) for i in alone)
        moved = max(float(np.abs(dirty[i] - alone[i]).max()) for i in alone)
        emit(phase="slot_reuse", arch=cfg.name, pool=2, requests=len(prompts),
             max_abs_logprob_diff=worst, tol=REUSE_TOL,
             dirty_max_abs_logprob_diff=moved)
        if worst > REUSE_TOL:
            raise AssertionError(f"{arch}: a reused slot's log-probs differ "
                                 f"from a fresh batcher's by {worst}")
        if moved <= REUSE_TOL:
            raise AssertionError(f"{arch}: left dirty, the recurrent state "
                                 f"moved no log-prob (the check is vacuous)")


def phase_recurrent() -> dict:
    """Phase 13: mamba2-2.7b and recurrentgemma-9b at full width.  Returns
    the kernels' launches on its paths."""
    from repro_torch import configs

    t_phase = time.perf_counter()
    recurrent_decode()
    serve_launches = recurrent_serve()
    recurrent_layer_costs()
    prefill_launches = recurrent_prefill()
    mcts = phase_mcts_lm(configs.get_config(MAMBA), reuses=(False,))
    slot_reuse()
    emit(phase="recurrent", seconds=time.perf_counter() - t_phase)
    return {"serve": serve_launches, "prefill_f32": prefill_launches,
            "mcts": mcts}

# ---------------------------------------------------------------------------
# phase 14: the MoE and MLA families (mixtral-8x22b, deepseek-v3-671b) at
# full width and cut depth
# ---------------------------------------------------------------------------

MIXTRAL, DEEPSEEK = "mixtral-8x22b", "deepseek-v3-671b"
MOE_SERVE = dict(batch=16, prefill=2048, tokens=64)
MIXTRAL_WINDOW = 4096
MIXTRAL_SERVE_HEADS = (16, 2048, 48, 8, 128)   # B, S, H, Hkv, dh
# the flash kernel at mixtral's heads on its paths: the serve prefill,
# (b)'s f32 prefill and (e)'s longest B=1 forward
MIXTRAL_SHAPES = [(16, 2048, 2048, 48, 8, 128), (4, 512, 512, 48, 8, 128),
                  (1, 43, 43, 48, 8, 128)]
GATE_TOL = 1e-7       # card against CPU gates: the same f32 division
MLA_PREFILL_TOL = 1e-4  # blockwise against naive MLA prefill, f32


def mixtral_cut(n_layers: int):
    """mixtral-8x22b at its published width with n_layers of its 56."""
    from repro_torch import configs

    cfg = configs.get_config(MIXTRAL)
    return dataclasses.replace(cfg, groups=((cfg.groups[0][0], n_layers),))


def deepseek_cut(n_moe: int):
    """deepseek-v3-671b at its published width: its 3 dense layers then
    n_moe of its 58 MoE layers."""
    from repro_torch import configs

    cfg = configs.get_config(DEEPSEEK)
    (dense, n), (moe, _) = cfg.groups
    moe_group = ((moe, n_moe),) if n_moe else ()
    return dataclasses.replace(cfg, groups=((dense, n),) + moe_group)


def reduced(cfg) -> str:
    from repro_torch import configs

    full = configs.get_config(cfg.name)
    return f"{cfg.n_layers} of {full.n_layers} layers, widths as published"


class Routes:
    """Inside `with`: every MoE dispatch of the port recorded (moe.dispatch
    wrapped), as the kept mask of each (token, k) pair [T, K] on the
    device; nothing is read back while recording."""

    def __enter__(self):
        from repro_torch.models import moe

        self.calls, self._dispatch = [], moe.dispatch

        def recorded(probs, K, capacity_factor=1.25):
            d = self._dispatch(probs, K, capacity_factor)
            kept = torch.empty_like(d.keep)
            kept[d.order] = d.keep
            self.calls.append(kept.view(-1, K))
            return d

        moe.dispatch = recorded
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe.dispatch = self._dispatch

    def dropped_rows(self, B: int, T: int) -> torch.Tensor:
        """[B] bool: rows (of B rows of T/B tokens) any of whose pairs was
        dropped in a recorded call over T tokens."""
        out = torch.zeros(B, dtype=torch.bool, device=DEV)
        for kept in self.calls:
            if kept.shape[0] == T:
                out |= (~kept).reshape(B, -1).any(1)
        return out

    def dropped_share(self, T: int) -> tuple:
        """(dropped pairs, pairs) over the recorded calls of T tokens."""
        calls = [k for k in self.calls if k.shape[0] == T]
        return (sum(int((~k).sum()) for k in calls),
                sum(k.numel() for k in calls))


def moe_dispatch_checks() -> dict:
    """(a) the dispatch at both archs' published E and K, at the serve's
    T = 16 x 2,048 tokens: router probabilities on the card from the
    router's logits (f32, TF32 off) over random hidden rows; the
    dispatch on the card against the same function on the CPU from the
    same probabilities, every integer identical and the gates within
    1e-7.  Three routers: as drawn; with its columns duplicated in pairs
    (exact ties: the lower expert of a pair must come first); skewed by a
    ramp over the experts (some overflow, so pairs drop)."""
    from repro_torch import configs
    from repro_torch.models import layers as L
    from repro_torch.models import moe

    torch.backends.cuda.matmul.allow_tf32 = False
    T = MOE_SERVE["batch"] * MOE_SERVE["prefill"]
    dropped = {}
    for arch in (MIXTRAL, DEEPSEEK):
        cfg = configs.get_config(arch)
        E, K, d = cfg.n_experts, cfg.top_k, cfg.d_model
        gen = torch.Generator(device=DEV).manual_seed(5)
        router = L.normal(gen, (d, E), torch.float32, 1.0 / np.sqrt(d))
        x = randn(gen, (T, d), torch.bfloat16)
        logits = x.float() @ router
        for case in ("drawn", "ties", "skewed"):
            lg = logits
            if case == "ties":
                lg = logits[:, 0::2].repeat_interleave(2, dim=1)
            elif case == "skewed":
                lg = logits + torch.linspace(0, 2, E, device=DEV)
            probs = torch.softmax(lg, -1)
            on_card = moe.dispatch(probs, K)
            on_cpu = moe.dispatch(probs.cpu(), K)
            torch.cuda.synchronize()
            diff = {name: int((getattr(on_card, name).cpu()
                               != getattr(on_cpu, name)).sum())
                    for name in ("eidx", "order", "slot", "keep")}
            gate_err = float((on_card.gate.cpu() - on_cpu.gate).abs().max())
            load = moe.expert_counts(on_cpu.eidx, E)
            keep = on_cpu.keep
            n_drop = int((~keep).sum())
            # each dropped pair's token and expert (order holds t*K + k)
            drop_t = torch.div(on_cpu.order[~keep], K, rounding_mode="floor")
            drop_x = on_cpu.eidx[drop_t, on_cpu.order[~keep] % K]
            ties_first = None
            if case == "ties":
                ties_first = bool(((on_cpu.eidx[:, 0::2] % 2 == 0)
                                   & (on_cpu.eidx[:, 1::2]
                                      == on_cpu.eidx[:, 0::2] + 1)).all())
            emit(phase="moe_dispatch", arch=arch, router=case, T=T, E=E, K=K,
                 C=on_cpu.C, mismatches=diff, max_gate_err=gate_err,
                 gate_tol=GATE_TOL, dropped_pairs=n_drop, pairs=T * K,
                 dropped_first=[[int(t), int(e)] for t, e in
                                zip(drop_t[:16], drop_x[:16])],
                 dropped_per_expert=moe.expert_counts(drop_x, E).tolist(),
                 load=load.tolist(), lower_expert_first_on_ties=ties_first)
            if any(diff.values()) or on_card.C != on_cpu.C or gate_err > GATE_TOL:
                raise AssertionError(f"{arch} {case}: the dispatch on the card "
                                     f"differs from the CPU's: {diff}, gates "
                                     f"{gate_err}")
            if case == "ties" and not ties_first:
                raise AssertionError(f"{arch}: tied experts out of order")
            if case == "skewed" and n_drop == 0:
                raise AssertionError(f"{arch}: the skewed router dropped no "
                                     f"pair (the check is vacuous)")
            dropped[f"{arch}/{case}"] = n_drop
        del router, x, logits
    return dropped


def teacher_rows(cfg, params, seq, S: int, impl, max_seq=None, **inputs):
    """Prefill seq[:, :S] (with inputs: frames or patches) with `impl`,
    then decode seq[:, S:] a token a step: the prefill's logits and each
    step's, [B, n + 1, V] for the n tokens after S.  max_seq: the caches'
    slots (default: a prefix's positions, seq's and 8 spare)."""
    from repro_torch.models import lm, steps

    B, n = seq.shape[0], seq.shape[1] - S
    caches = lm.init_caches(cfg, B, max_seq or cfg.vlm_patches + seq.shape[1] + 8,
                            DEV)
    lg, caches = steps.make_prefill_step(cfg, impl=impl)(params, seq[:, :S],
                                                         caches, **inputs)
    decode = steps.make_decode_step(cfg, impl=impl)
    rows = [lg]
    positions = torch.arange(S, S + n, device=DEV)
    for i in range(n):
        lg, caches = decode(params, caches, seq[:, S + i:S + i + 1], positions[i])
        rows.append(lg)
    return torch.stack(rows, 1)


def moe_decode() -> int:
    """(b) mixtral-8x22b at 2 layers in an f32 copy (TF32 off), 4 prompts
    of 512 tokens: the flash prefill within 1e-3 of the blockwise prefill
    (both route the same 2,048 tokens), argmax identical; then 32 greedy
    decode tokens, each row within 2e-3 of the teacher-forced forward.
    The forward routes 4 x 544 tokens, so its capacity differs from the
    prefill's: rows (prompts) any of whose pairs dropped in either are
    left out, and none compared is a failure.  Returns the flash
    launches of the flash prefill."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import lm, steps

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(mixtral_cut(2), dtype="float32")
    params = lm.init_params(cfg, torch.Generator(device=DEV).manual_seed(0), DEV)
    B, S, n = 4, 512, 32
    tokens = torch.randint(0, cfg.vocab, (B, S), device=DEV,
                           generator=torch.Generator(device=DEV).manual_seed(1))
    t0 = time.perf_counter()
    FA.launches = 0
    with Routes() as prefill_routes:
        got, seq = decode_rows(cfg, params, tokens, n, "flash")
    launches = FA.launches
    caches = lm.init_caches(cfg, B, S + 8, DEV)
    lb, _ = steps.make_prefill_step(cfg, impl="blockwise")(params, tokens, caches)
    del caches
    d = float((got[:, 0] - lb).abs().max())
    agree = float((got[:, 0].argmax(-1) == lb.argmax(-1)).float().mean())
    with Routes() as forward_routes:
        want = forward_rows(cfg, params, seq, S - 1, "blockwise")
    skip = (prefill_routes.dropped_rows(B, B * S)
            | forward_routes.dropped_rows(B, B * (S + n)))
    decode_drops = sum(int((~k).sum()) for k in prefill_routes.calls
                       if k.shape[0] == B)
    rows = (~skip).nonzero().flatten()
    compared = int(rows.numel())
    check = (against_forward("(b)", cfg, got[rows], want[rows], DECODE_TOL)
             if compared else {})
    emit(phase="moe_decode", arch=cfg.name, reduced=reduced(cfg),
         dtype="float32", tf32=False, batch=B, prompt=S, flash_launches=launches,
         flash_vs_blockwise_max_abs_diff=d, flash_vs_blockwise_argmax=agree,
         decode_tokens=n, rows_compared=compared,
         rows_with_drops=skip.tolist(),
         prefill_dropped=prefill_routes.dropped_share(B * S),
         forward_dropped=forward_routes.dropped_share(B * (S + n)),
         decode_dropped=decode_drops, decode_vs_forward=check,
         seconds=time.perf_counter() - t0)
    if launches != attn_layers(cfg):
        raise AssertionError(f"flash launched {launches} times in one prefill "
                             f"of {attn_layers(cfg)} attention layers")
    if d > PREFILL_TOL or agree != 1.0:
        raise AssertionError(f"f32 flash prefill differs from blockwise: max "
                             f"|d logits| {d}, argmax agreement {agree}")
    if compared == 0 or decode_drops:
        raise AssertionError(f"(b): {compared} rows compared, {decode_drops} "
                             f"pairs dropped in decode")
    del params
    return launches


def mla_decode():
    """(c) deepseek-v3-671b's 3 dense (MLA) layers at full width in an f32
    copy (TF32 off), one prompt of 2,048 tokens: the blockwise prefill
    against the naive prefill within 1e-4 (hidden states at every
    position and the last logits); then 16 decode tokens through the
    decompressed cache and absorbed, each row within 2e-3 of the
    teacher-forced forward and of each other."""
    from repro_torch.models import layers as L
    from repro_torch.models import lm

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(deepseek_cut(0), dtype="float32")
    params = lm.init_params(cfg, torch.Generator(device=DEV).manual_seed(0), DEV)
    S, n = 2048, 16
    tokens = torch.randint(0, cfg.vocab, (1, S), device=DEV,
                           generator=torch.Generator(device=DEV).manual_seed(1))
    t0 = time.perf_counter()
    hb, _ = lm.hidden_states(cfg, params, tokens, impl="blockwise")
    hn, _ = lm.hidden_states(cfg, params, tokens, impl="naive")
    dh = float((hb - hn).abs().max())
    dl = float((L.unembed(cfg, params["embed"], hb[:, -1])
                - L.unembed(cfg, params["embed"], hn[:, -1])).abs().max())
    del hb, hn
    got, seq = decode_rows(cfg, params, tokens, n, "blockwise")
    absorbed = teacher_rows(dataclasses.replace(cfg, mla_absorb=True), params,
                            seq, S, "blockwise")
    want = forward_rows(cfg, params, seq, S - 1, "blockwise")
    check = against_forward("(c) decompressed", cfg, got, want, DECODE_TOL)
    check_abs = against_forward("(c) absorbed", cfg, absorbed, want, DECODE_TOL)
    check_pair = against_forward("(c) absorbed vs decompressed", cfg, absorbed,
                                 got, DECODE_TOL)
    emit(phase="mla_decode", arch=cfg.name, reduced=reduced(cfg),
         dtype="float32", tf32=False, batch=1, prompt=S,
         blockwise_vs_naive_hidden_max_abs_diff=dh,
         blockwise_vs_naive_logits_max_abs_diff=dl, tol=MLA_PREFILL_TOL,
         decode_tokens=n, decompressed_vs_forward=check,
         absorbed_vs_forward=check_abs, absorbed_vs_decompressed=check_pair,
         seconds=time.perf_counter() - t0)
    if dh > MLA_PREFILL_TOL or dl > MLA_PREFILL_TOL:
        raise AssertionError(f"MLA blockwise prefill differs from naive: "
                             f"hidden {dh}, logits {dl}")
    del params


def moe_serve() -> dict:
    """(d) serve.serve at both cut archs (mixtral 8 layers, deepseek its 3
    dense and 2 MoE layers), bf16, 16 prompts of 2,048 tokens then 64
    tokens: a warm run (its routes recorded: the share of pairs dropped
    in the prefill), then the timed run: prefill ms, decode tokens/s,
    peak memory, the flash kernel's launches (one per mixtral layer, none
    for MLA).  TF32 must be off (the routers' logits are f32 products)."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import serve

    launches = {}
    B, S, T = MOE_SERVE["batch"], MOE_SERVE["prefill"], MOE_SERVE["tokens"]
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the routers' f32 logits, and with "
                             "them the routes, would move")
    for arch, cfg in ((MIXTRAL, mixtral_cut(8)), (DEEPSEEK, deepseek_cut(2))):
        with Routes() as routes:
            serve.serve(cfg, **MOE_SERVE)          # warm: cuBLAS, allocator
        drop = routes.dropped_share(B * S)
        del routes
        FA.launches = 0
        out = serve.serve(cfg, **MOE_SERVE)
        launches[arch] = FA.launches
        want = attn_layers(cfg) if cfg.attn_impl == "gqa" else 0
        toks = out["tokens"]
        emit(phase="moe_serve", arch=cfg.name, reduced=reduced(cfg),
             shape=f"{B} x {S} + {T}", device=out["device"],
             prefill_ms=1e3 * out["prefill_s"],
             decode_tokens_per_s=B * T / out["decode_s"],
             decode_ms_per_step=1e3 * out["decode_s"] / T,
             req_per_s=out["req_per_s"], peak_gib=out["peak_bytes"] / 2**30,
             prefill_dropped_pairs=drop[0], prefill_pairs=drop[1],
             prefill_dropped_share=drop[0] / max(drop[1], 1),
             flash_launches=launches[arch], tf32=False)
        if launches[arch] != want:
            raise AssertionError(f"{arch}: serve prefill launched flash "
                                 f"{launches[arch]} times, not {want}")
        if toks.shape != (B, T + 1) or toks.min() < 0 \
                or toks.max() >= cfg.padded_vocab:
            raise AssertionError(f"{arch}: serve tokens out of shape or range")
        del out
        release()
    return launches


def moe_layer_costs():
    """(f) where a MoE layer's time goes, at the serve prefill (16 x 2,048
    tokens) and one decode step (16 tokens), bf16 random weights: the
    router, the dispatch, the expert products (with the gather), the
    combine and deepseek's shared expert, each on the host's clock, its
    device time and busy share (torch.profiler); and one MLA layer's
    prefill (blockwise) and decode step (decompressed and absorbed)."""
    from repro_torch import configs
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models import moe

    B, S = MOE_SERVE["batch"], MOE_SERVE["prefill"]
    for arch in (MIXTRAL, DEEPSEEK):
        cfg = configs.get_config(arch)
        p = moe.init_moe(cfg, torch.Generator(device=DEV).manual_seed(0))
        gen = torch.Generator(device=DEV).manual_seed(1)
        for label, T in (("prefill", B * S), ("decode_step", B)):
            xf = randn(gen, (T, cfg.d_model), L.dt(cfg))
            probs = moe.route(p, xf)
            dsp = moe.dispatch(probs, cfg.top_k)
            ye = moe.experts(cfg, p, xf, dsp)
            parts = {"router": lambda: moe.route(p, xf),
                     "dispatch": lambda: moe.dispatch(probs, cfg.top_k),
                     "experts": lambda: moe.experts(cfg, p, xf, dsp),
                     "combine": lambda: moe.combine(ye, dsp)}
            if cfg.n_shared_experts:
                parts["shared"] = lambda: L.mlp(cfg, p["shared"], xf)
            parts["layer"] = lambda: moe.moe_forward(cfg, p, xf[None])
            n = 3 if label == "prefill" else 10
            times = {k: wall_and_device_ms(fn, n) for k, fn in parts.items()}
            # the expert products read every expert's weights once: a
            # device time under that read at the HBM rate is a profiler
            # undercount (records lost), not a speed
            weight_bytes = 3 * cfg.n_experts * cfg.d_model * cfg.moe_d_ff * 2
            hbm_floor_ms = 1e3 * weight_bytes / H100_HBM_BYTES_PER_S
            for k in ("experts", "layer"):
                times[k]["device_undercount"] = \
                    times[k]["device_ms"] < hbm_floor_ms
            emit(phase="moe_layer", arch=cfg.name, part=label, T=T, C=dsp.C,
                 E=cfg.n_experts, K=cfg.top_k,
                 expert_weight_gb=weight_bytes / 1e9,
                 hbm_floor_ms=hbm_floor_ms, **times)
            del xf, probs, dsp, ye, parts
        del p
        release()

    cfg = configs.get_config(DEEPSEEK)
    spec = cfg.groups[0][0][0]
    p = A.init_attn(cfg, torch.Generator(device=DEV).manual_seed(0), spec)
    gen = torch.Generator(device=DEV).manual_seed(1)
    x = randn(gen, (B, S, cfg.d_model), L.dt(cfg))
    pos = torch.arange(S, device=DEV)
    cache = A.init_cache(cfg, spec, B, S + MOE_SERVE["tokens"] + 8, DEV)
    out = {"prefill": wall_and_device_ms(
        lambda: A.attn_forward(cfg, spec, p, x, pos, None, impl="flash"), 3)}
    A.attn_forward(cfg, spec, p, x, pos, cache, impl="flash")
    x1, pos1 = x[:, :1], torch.tensor([S], device=DEV)
    for absorb in (False, True):
        c = dataclasses.replace(cfg, mla_absorb=absorb)
        out["decode_absorbed" if absorb else "decode_decompressed"] = \
            wall_and_device_ms(lambda: A.attn_forward(  # rewrites slot S alike
                c, spec, p, x1, pos1, cache), 10)
    emit(phase="mla_layer", arch=cfg.name, shape=f"B={B} S={S} {cfg.dtype}",
         cache_slots=cache["c"].shape[1], **out)
    del p, x, cache


def release() -> float:
    """Collect what earlier work left to the garbage collector (an MCTS
    run's driver holds its model in a reference cycle through `logged`)
    and return the cached blocks, before a sub-phase that fills most of
    the card; returns the GiB still allocated."""
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated() / 2**30


def phase_moe() -> dict:
    """Phase 14: mixtral-8x22b and deepseek-v3-671b at full width and cut
    depth.  Returns the kernels' launches on its paths and flash's row at
    mixtral's serve shape."""
    t_phase = time.perf_counter()
    held = release()
    dropped = moe_dispatch_checks()
    f32_launches = moe_decode()
    release()
    mla_decode()
    release()
    serve_launches = moe_serve()
    release()
    mcts = phase_mcts_lm(mixtral_cut(8), reuses=(False,))
    release()
    moe_layer_costs()
    row = flash_timing(MIXTRAL_SERVE_HEADS, 5, window=MIXTRAL_WINDOW)
    emit(phase="moe", seconds=time.perf_counter() - t_phase,
         held_gib_at_start=held, dispatch_dropped=dropped)
    return {"serve": serve_launches, "prefill_f32": f32_launches, "mcts": mcts,
            "flash_row": row}


# ---------------------------------------------------------------------------
# phase 15: the encoder and the VLM prefix (whisper-small, paligemma-3b)
# ---------------------------------------------------------------------------

WHISPER_SERVE = dict(batch=16, prefill=384, tokens=64)
PALIGEMMA_SERVE = dict(batch=16, prefill=2048, tokens=64)
CARD_CPU_TOL = 1e-4    # the card's f32 forward against the CPU's
LAUNCHER_MOVE = 1e-2   # the launcher-sized cache must move decode past this


def stub_inputs(cfg, B: int, seed: int) -> dict:
    """Seeded non-zero stub embeddings on the card, f32: frames [B,
    n_frames, d] (whisper) or patches [B, P, d] (paligemma)."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    out = {}
    if cfg.encoder is not None:
        out["frames"] = torch.randn((B, cfg.encoder.n_frames, cfg.d_model),
                                    generator=gen, device=DEV)
    if cfg.vlm_patches:
        out["patches"] = torch.randn((B, cfg.vlm_patches, cfg.d_model),
                                     generator=gen, device=DEV)
    return out


def on_cpu(tree):
    """A copy of a parameter tree (dicts and lists of tensors) on the CPU."""
    if isinstance(tree, dict):
        return {k: on_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [on_cpu(v) for v in tree]
    return tree.cpu()


def flash_per_prefill(cfg) -> int:
    """Flash launches in one prefill by serve's route: one a GQA attention
    layer, one more a cross-attention layer, one an encoder layer; none
    on the blockwise route (MLA, a prefix)."""
    from repro_torch.launch import serve

    if serve.prefill_impl(cfg) != "flash":
        return 0
    cross = sum(spec.cross_attn for spec in cfg.layer_specs())
    enc = cfg.encoder.n_layers if cfg.encoder is not None else 0
    return attn_layers(cfg) + cross + enc


def whisper_checks() -> int:
    """(a) whisper-small at full width in an f32 copy (TF32 off), 4 prompts
    of 384 tokens over seeded frames: the flash prefill (encoder,
    self-attention and cross-attention on the kernel) within 1e-3 of the
    naive prefill (the JAX package's path), argmax identical; 32 greedy
    decode tokens, each row within 2e-3 of the teacher-forced forward
    over the same frames (the cross K/V read back from the cache); the
    card's forward of one prompt within 1e-4 of the port's on the CPU.
    Returns the flash prefill's launches."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import lm, steps

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(configs.get_config(WHISPER), dtype="float32")
    params = lm.init_params(cfg, torch.Generator(device=DEV).manual_seed(0), DEV)
    B, S, n = 4, WHISPER_SERVE["prefill"], 32
    tokens = torch.randint(0, cfg.vocab, (B, S), device=DEV,
                           generator=torch.Generator(device=DEV).manual_seed(1))
    frames = stub_inputs(cfg, B, 2)["frames"]
    t0 = time.perf_counter()
    FA.launches = 0
    got, seq = decode_rows(cfg, params, tokens, n, "flash", frames=frames)
    launches = FA.launches
    caches = lm.init_caches(cfg, B, S + 8, DEV)
    ln, _ = steps.make_prefill_step(cfg, impl="naive")(params, tokens, caches,
                                                       frames=frames)
    del caches
    d = float((got[:, 0] - ln).abs().max())
    agree = float((got[:, 0].argmax(-1) == ln.argmax(-1)).float().mean())
    want = forward_rows(cfg, params, seq, S - 1, "naive", frames=frames)
    check = against_forward("(a)", cfg, got, want, DECODE_TOL)
    del got, want
    card = lm.forward(cfg, params, tokens[:1], impl="flash",
                      frames=frames[:1])[0].cpu()
    cpu = lm.forward(cfg, on_cpu(params), tokens[:1].cpu(), impl="flash",
                     frames=frames[:1].cpu())[0]
    d_cpu = float((card - cpu).abs().max())
    ok_cpu = bool((card - cpu).abs().le(CARD_CPU_TOL + CARD_CPU_TOL
                                        * cpu.abs()).all())
    emit(phase="encdec_whisper", arch=cfg.name, dtype="float32", tf32=False,
         batch=B, prompt=S, frames=cfg.encoder.n_frames, flash_launches=launches,
         flash_vs_naive_max_abs_diff=d, flash_vs_naive_argmax=agree,
         decode_tokens=n, decode_vs_forward=check,
         card_vs_cpu_max_abs_diff=d_cpu, card_vs_cpu_tol=CARD_CPU_TOL,
         seconds=time.perf_counter() - t0)
    if launches != flash_per_prefill(cfg):
        raise AssertionError(f"whisper's flash prefill launched the kernel "
                             f"{launches} times, not {flash_per_prefill(cfg)}")
    if d > PREFILL_TOL or agree != 1.0:
        raise AssertionError(f"whisper's f32 flash prefill differs from naive: "
                             f"max |d logits| {d}, argmax agreement {agree}")
    if not ok_cpu:
        raise AssertionError(f"whisper's forward on the card differs from the "
                             f"CPU's by {d_cpu}")
    del params
    return launches


def paligemma_checks() -> dict:
    """(b) paligemma-3b at full width in an f32 copy (TF32 off), 2 prompts
    of 256 tokens behind 256 seeded patches: the blockwise prefix prefill
    within 1e-3 of naive, argmax identical; 16 greedy decode tokens with
    the serve-sized cache (P + prompt + new + 8), each row within 2e-3 of
    the teacher-forced forward; the same tokens teacher-forced through
    the JAX launcher's cache (prompt + new + 8, which the prefix overruns)
    must move the decode rows off the forward by more than 1e-2."""
    from repro_torch import configs
    from repro_torch.models import lm, steps

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(configs.get_config(PALIGEMMA), dtype="float32")
    params = lm.init_params(cfg, torch.Generator(device=DEV).manual_seed(0), DEV)
    B, S, n, P = 2, 256, 16, cfg.vlm_patches
    tokens = torch.randint(0, cfg.vocab, (B, S), device=DEV,
                           generator=torch.Generator(device=DEV).manual_seed(1))
    patches = stub_inputs(cfg, B, 2)["patches"]
    t0 = time.perf_counter()
    got, seq = decode_rows(cfg, params, tokens, n, "blockwise", patches=patches)
    caches = lm.init_caches(cfg, B, P + S + 8, DEV)
    ln, _ = steps.make_prefill_step(cfg, impl="naive")(params, tokens, caches,
                                                       patches=patches)
    del caches
    d = float((got[:, 0] - ln).abs().max())
    agree = float((got[:, 0].argmax(-1) == ln.argmax(-1)).float().mean())
    want = forward_rows(cfg, params, seq, P + S - 1, "blockwise", patches=patches)
    check = against_forward("(b)", cfg, got, want, DECODE_TOL)
    launcher = teacher_rows(cfg, params, seq, S, "blockwise",
                            max_seq=S + n + 8, patches=patches)
    moved = float((launcher[:, 1:] - want[:, 1:]).abs().max())
    out = dict(blockwise_vs_naive_max_abs_diff=d, blockwise_vs_naive_argmax=agree,
               decode_vs_forward=check, launcher_cache_slots=S + n + 8,
               serve_cache_slots=P + S + n + 8,
               launcher_cache_decode_vs_forward=moved,
               launcher_cache_prefill_row_diff=float(
                   (launcher[:, 0] - want[:, 0]).abs().max()))
    emit(phase="encdec_paligemma", arch=cfg.name, dtype="float32", tf32=False,
         batch=B, patches=P, prompt=S, decode_tokens=n, **out,
         launcher_move_bound=LAUNCHER_MOVE, seconds=time.perf_counter() - t0)
    if d > PREFILL_TOL or agree != 1.0:
        raise AssertionError(f"paligemma's blockwise prefix prefill differs "
                             f"from naive: max |d logits| {d}, argmax {agree}")
    if not moved > LAUNCHER_MOVE:
        raise AssertionError(f"the launcher-sized cache moved decode only "
                             f"{moved}: the prefix's positions are not held")
    del params
    return out


def encdec_serve() -> dict:
    """(c) serve.serve at both archs, bf16, with seeded stub inputs:
    whisper-small 16 prompts of 384 tokens over 1,500 frames then 64
    tokens, paligemma-3b 16 prompts of 2,048 tokens behind 256 patches
    then 64 tokens; a warm run, then the timed one: prefill ms, decode
    tokens/s, peak memory, the route, and the flash launches (36 for
    whisper: 12 encoder layers, 12 self- and 12 cross-attentions; none
    for the prefix)."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import serve

    launches = {}
    for arch, shape in ((WHISPER, WHISPER_SERVE), (PALIGEMMA, PALIGEMMA_SERVE)):
        cfg = configs.get_config(arch)
        B, S, T = shape["batch"], shape["prefill"], shape["tokens"]
        inputs = stub_inputs(cfg, B, 3)
        serve.serve(cfg, **shape, **inputs)        # warm: cuBLAS, allocator
        FA.launches = 0
        out = serve.serve(cfg, **shape, **inputs)
        launches[arch] = FA.launches
        toks = out["tokens"]
        emit(phase="encdec_serve", arch=cfg.name,
             shape=f"{B} x ({cfg.vlm_patches} + {S}) + {T}" if cfg.vlm_patches
             else f"{B} x {S} + {T}, {cfg.encoder.n_frames} frames",
             device=out["device"], route=out["prefill_impl"],
             prefill_ms=1e3 * out["prefill_s"],
             decode_tokens_per_s=B * T / out["decode_s"],
             decode_ms_per_step=1e3 * out["decode_s"] / T,
             req_per_s=out["req_per_s"], peak_gib=out["peak_bytes"] / 2**30,
             flash_launches=launches[arch])
        if launches[arch] != flash_per_prefill(cfg):
            raise AssertionError(f"{arch}: serve prefill launched flash "
                                 f"{launches[arch]} times, not "
                                 f"{flash_per_prefill(cfg)}")
        if toks.shape != (B, T + 1) or toks.min() < 0 \
                or toks.max() >= cfg.padded_vocab:
            raise AssertionError(f"{arch}: serve tokens out of shape or range")
        del out, inputs
        release()
    return launches


def encdec_costs():
    """Where (c)'s time goes: one prefill and one decode step of each arch
    at its serve shape, bf16, seeded random weights and stub inputs: ms
    on the host's clock, device ms, busy share and the top kernels
    (torch.profiler).  The prefill rewrites the same cache slots on every
    call, the decode step slot S, so every call does the same work."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import lm, steps

    for arch, shape in ((WHISPER, WHISPER_SERVE), (PALIGEMMA, PALIGEMMA_SERVE)):
        cfg = configs.get_config(arch)
        B, S, T = shape["batch"], shape["prefill"], shape["tokens"]
        gen = torch.Generator(device=DEV).manual_seed(0)
        params = lm.init_params(cfg, gen, DEV)
        tokens = torch.randint(0, cfg.vocab, (B, S), device=DEV, generator=gen)
        inputs = stub_inputs(cfg, B, 3)
        caches = lm.init_caches(cfg, B, serve.cache_len(cfg, S, T), DEV)
        impl = serve.prefill_impl(cfg)
        pre = steps.make_prefill_step(cfg, impl=impl)
        dec = steps.make_decode_step(cfg, impl=impl)
        prefill = wall_and_device_ms(lambda: pre(params, tokens, caches, **inputs), 2)
        pos = torch.tensor(S, device=DEV)
        decode = wall_and_device_ms(lambda: dec(params, caches, tokens[:, :1], pos), 10)
        emit(phase="encdec_costs", arch=cfg.name, route=impl,
             shape=f"B={B} S={S} P={cfg.vlm_patches} {cfg.dtype}", prefill=prefill,
             decode_step=decode)
        del params, caches, inputs
        release()


def phase_encdec() -> dict:
    """Phase 15: whisper-small and paligemma-3b at full width and depth.
    Returns the flash kernel's launches on their paths and its rows at
    whisper's encoder and cross-attention shapes."""
    t_phase = time.perf_counter()
    held = release()
    f32_launches = whisper_checks()
    release()
    paligemma = paligemma_checks()
    release()
    serve_launches = encdec_serve()
    encdec_costs()
    B, S = WHISPER_SERVE["batch"], WHISPER_SERVE["prefill"]
    n_frames, H, dh = 1500, 12, 64
    rows = {"encoder": flash_timing((B, n_frames, H, H, dh), 6, causal=False),
            "cross": flash_timing((B, S, H, H, dh), 7, kv_len=n_frames,
                                  causal=False)}
    emit(phase="encdec", seconds=time.perf_counter() - t_phase,
         held_gib_at_start=held,
         launcher_cache_decode_vs_forward=paligemma[
             "launcher_cache_decode_vs_forward"])
    return {"serve": serve_launches, "prefill_f32": f32_launches, "rows": rows}


# ---------------------------------------------------------------------------
# phase 16: training on the card
# ---------------------------------------------------------------------------

TRAIN_TOL = 1e-4       # (a) card vs CPU, relative; (c) tests/test_checkpoint.py:89
TRAIN_FULL = dict(steps=20, batch=8, seq=512)     # (b) llama3.2-1b, full depth
TRAIN_PROFILED = 10    # (b)'s step run under the profiler (not in the median)
TRAIN_REPLAY = dict(batch=2, seq=64)              # (c) 1 layer, 6 = 3 + 3 steps
TRAIN_MTP = dict(steps=5, batch=4, seq=512)       # (d) deepseek-v3 3 dense + MTP
TRAIN_CPU = dict(steps=3, batch=2, seq=64)        # (a) 2 layers, f32


def llama_cut(n_layers: int):
    """llama3.2-1b at its published width with n_layers of its 16."""
    from repro_torch import configs

    cfg = configs.get_config(LLAMA)
    return dataclasses.replace(cfg, groups=((cfg.groups[0][0], n_layers),))


def train_argv(steps: int, batch: int, seq: int, extra=()) -> list:
    return ["--steps", str(steps), "--batch", str(batch), "--seq", str(seq),
            "--log-every", "1", *extra]


class TimedSteps:
    """Inside `with`: every train step the launcher makes
    (steps.make_train_step wrapped) timed on the host's clock from a
    synchronize to its metrics read back, every step's metrics kept, with
    keep_params the first step's input parameters and the last step's
    output parameters kept (the step is functional, so nothing is copied,
    but the first tree stays allocated), and the step numbered
    `profile_at` run under torch.profiler instead (device busy share, top
    kernels).  state_bytes: the memory allocated when the first step is
    called, beyond what was allocated on entering (the parameters and the
    optimizer state the launcher built, and the first batch)."""

    def __init__(self, profile_at=None, keep_params=False):
        self.profile_at, self.keep_params = profile_at, keep_params
        self.ms, self.metrics, self.first, self.last = [], [], None, None
        self.profile = None
        self.state_bytes = None

    def __enter__(self):
        from repro_torch.models import steps

        self.base = torch.cuda.memory_allocated()
        self._make = steps.make_train_step

        def make(*a, **kw):
            step = self._make(*a, **kw)

            def timed(params, opt_state, i, batch):
                if self.first is None and self.keep_params:
                    self.first = params
                torch.cuda.synchronize()
                if self.state_bytes is None:    # the state the launcher built
                    self.state_bytes = torch.cuda.memory_allocated() - self.base
                if len(self.metrics) == self.profile_at:
                    out, self.profile = profiled(
                        lambda: step(params, opt_state, i, batch))
                else:
                    t0 = time.perf_counter()
                    out = step(params, opt_state, i, batch)
                    float(out[2]["loss"])
                    self.ms.append(1e3 * (time.perf_counter() - t0))
                self.metrics.append({k: float(v) for k, v in out[2].items()})
                if self.keep_params:
                    self.last = out[0]
                return out

            return timed

        steps.make_train_step = make
        return self

    def __exit__(self, *exc):
        from repro_torch.models import steps

        steps.make_train_step = self._make

    def check_finite(self, label: str, keys) -> None:
        for i, m in enumerate(self.metrics):
            bad = [k for k in keys if not np.isfinite(m[k])]
            if bad:
                raise AssertionError(f"{label}: step {i} {bad} not finite: {m}")

    def changed(self) -> dict:
        """Share of the parameter entries the run changed, by dtype, and
        the leaves it left untouched (of how many)."""
        from repro_torch.pytree import tree_leaves

        moved, total, still = {}, {}, 0
        leaves = list(zip(tree_leaves(self.first), tree_leaves(self.last)))
        for a, b in leaves:
            k = str(a.dtype).removeprefix("torch.")
            n = int((a != b).sum())
            moved[k] = moved.get(k, 0) + n
            total[k] = total.get(k, 0) + a.numel()
            still += n == 0
        return {"entries_changed": {k: moved[k] / total[k] for k in total},
                "leaves_unchanged": still, "leaves": len(leaves)}


def profiled(fn):
    """(fn(), {wall_ms, device_ms (the union of the device events'
    intervals), busy, top: the five kernels with the most device time})
    of one call under torch.profiler, ending in a synchronize.  An empty
    profile goes first: the profiler's first start in a process takes
    seconds (8.9 s of wall around a 0.38 s step in its first run)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    union, _, _ = device_intervals_ms(prof)
    self_ms = sorted(((getattr(e, "self_device_time_total", None)
                       or getattr(e, "self_cuda_time_total", 0.0)) / 1e3,
                      e.key[:90]) for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA)
    return out, {"wall_ms": wall, "device_ms": union, "busy": union / wall,
                 "top": [[k, ms] for ms, k in self_ms[::-1][:5]]}


def train_card_vs_cpu() -> float:
    """(a) llama3.2-1b at its width, 2 layers, f32 (TF32 off): one seeded
    init on the CPU moved to the card; 3 train steps of B=2, S=64
    (naive, AdamW at lr 1e-3 after one warmup step) on both from the same
    batches.  Returns the largest relative difference of loss, nll and
    grad_norm over the steps; raises past TRAIN_TOL."""
    from repro_torch.data import SyntheticTokens
    from repro_torch.models import lm, steps
    from repro_torch.optim import make_optimizer
    from repro_torch.pytree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(llama_cut(2), dtype="float32")
    n, B, S = TRAIN_CPU["steps"], TRAIN_CPU["batch"], TRAIN_CPU["seq"]
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    init, update = make_optimizer("adamw", lr=1e-3, warmup=1)
    step = steps.make_train_step(cfg, update, impl="naive")
    src = SyntheticTokens(cfg.vocab, B, S, seed=0)
    runs, secs = {}, {}
    for dev in ("cpu", DEV):
        t0 = time.perf_counter()
        p = tree_map(lambda t: t.to(dev), params)
        st, out = init(p), []
        for i in range(n):
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in src.batch_at(i).items()}
            p, st, m = step(p, st, i, batch)
            out.append({k: float(m[k]) for k in ("loss", "nll", "grad_norm")})
        runs[dev], secs[dev] = out, time.perf_counter() - t0
        del p, st
    worst = max(abs(g[k] - c[k]) / max(abs(c[k]), 1e-30)
                for c, g in zip(runs["cpu"], runs[DEV]) for k in c)
    emit(phase="train_card_vs_cpu", arch=cfg.name, reduced=reduced(cfg),
         shape=f"B={B} S={S} float32, naive, AdamW", steps=n,
         cpu=runs["cpu"], card=runs[DEV], max_rel_diff=worst, tol=TRAIN_TOL,
         seconds=secs)
    if not worst <= TRAIN_TOL:
        raise AssertionError(f"train steps on the card differ from the CPU's "
                             f"by {worst:.3e} (relative) > {TRAIN_TOL}")
    return worst


def train_launcher(cfg, shape: dict, keys, label: str, profile_at=None,
                   check_moved=False) -> dict:
    """The launcher (repro_torch.launch.train) over cfg on the card, its
    steps timed (TimedSteps); raises unless every step's `keys` are
    finite and, with check_moved, some parameter moved (the peak then
    includes the first step's parameters, held for the check).  Returns
    its numbers."""
    from repro_torch.launch import specs, train

    B, S = shape["batch"], shape["seq"]
    release()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with TimedSteps(profile_at, keep_params=check_moved) as ts:
        losses = train.train(cfg, train.parse_args(train_argv(**shape)), DEV)
    secs = time.perf_counter() - t0
    ts.check_finite(label, keys)
    moved = ts.changed() if check_moved else {}
    if check_moved and moved["leaves_unchanged"] == moved["leaves"]:
        raise AssertionError(f"{label}: no parameter changed")
    ms = float(np.median(ts.ms[1:]))
    out = dict(arch=cfg.name, reduced=reduced(cfg),
               shape=f"B={B} S={S} {cfg.dtype}, {train.train_impl(S)}",
               optimizer=specs.optimizer_for(cfg)[0],
               steps=len(ts.metrics), first_step_ms=ts.ms[0],
               ms_per_step=ms, tokens_per_s=B * S / (ms / 1e3),
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               seconds=secs, losses=[m["loss"] for m in ts.metrics],
               logged=losses, state_bytes=ts.state_bytes,
               tf32=torch.backends.cuda.matmul.allow_tf32, **moved)
    for k in keys[1:]:
        out[k] = [m[k] for m in ts.metrics]
    if ts.profile is not None:
        out["profiled_step"] = dict(
            ts.profile, busy_of_median_step=ts.profile["device_ms"] / ms)
    del ts
    release()
    return out


def train_replay() -> dict:
    """(c) restart-replay on the card: llama3.2-1b's width, 1 layer, bf16,
    B=2, S=64: 6 steps straight, then 3 steps with --ckpt (a temp dir,
    removed afterwards) and a resume to step 6; the final losses within
    TRAIN_TOL.  Then 6 steps with --compress, reported."""
    import tempfile

    from repro_torch.launch import train

    cfg = llama_cut(1)
    shape = TRAIN_REPLAY
    t = {}
    t0 = time.perf_counter()
    straight = train.train(cfg, train.parse_args(train_argv(6, **shape)), DEV)
    t["straight"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        t0 = time.perf_counter()
        ckpt = ("--ckpt", d, "--ckpt-every", "100")
        first = train.train(cfg, train.parse_args(train_argv(
            3, **shape, extra=ckpt)), DEV)
        t["first_3_and_save"] = time.perf_counter() - t0
        ckpt_bytes = sum(f.stat().st_size for f in Path(d).rglob("*")
                         if f.is_file())
        t0 = time.perf_counter()
        resumed = train.train(cfg, train.parse_args(train_argv(
            6, **shape, extra=ckpt)), DEV)
        t["restore_3_and_save"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    compressed = train.train(cfg, train.parse_args(train_argv(
        6, **shape, extra=("--compress",))), DEV)
    t["compress"] = time.perf_counter() - t0
    diff = abs(straight[-1] - resumed[-1])
    emit(phase="train_replay", arch=cfg.name, reduced=reduced(cfg),
         shape=f"B={shape['batch']} S={shape['seq']} {cfg.dtype}, naive, AdamW",
         straight=straight, first=first, resumed=resumed,
         final_loss_diff=diff, resumed_max_diff=max(
             abs(a - b) for a, b in zip(straight[3:], resumed)),
         tol=TRAIN_TOL, checkpoint_gib=ckpt_bytes / 2**30,
         compressed=compressed, seconds=t)
    if not diff <= TRAIN_TOL:
        raise AssertionError(f"restart-replay: final loss {resumed[-1]} vs "
                             f"{straight[-1]} straight ({diff:.3e} > {TRAIN_TOL})")
    if not all(np.isfinite(compressed)):
        raise AssertionError(f"--compress losses not finite: {compressed}")
    return {"final_loss_diff": diff}


def flash_under_autograd() -> None:
    """(e) impl="flash" under autograd raises on the card before it
    launches (the kernel has no backward)."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import attention as A

    cfg = configs.get_config(LLAMA)
    spec = cfg.layer_specs()[0]
    gen = torch.Generator(device=DEV).manual_seed(0)
    d, H, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {k: (torch.randn(shape, generator=gen, device=DEV) * 0.02).to(
            torch.bfloat16).requires_grad_(True)
         for k, shape in (("wq", (d, H, dh)), ("wk", (d, Hkv, dh)),
                          ("wv", (d, Hkv, dh)), ("wo", (H, dh, d)))}
    x = torch.randn((2, 64, d), generator=gen, device=DEV).to(torch.bfloat16)
    pos = torch.arange(64, dtype=torch.int32, device=DEV)
    n0 = FA.launches
    try:
        A.attn_forward(cfg, spec, p, x, pos, impl="flash")
    except ValueError as e:
        msg = str(e)
    else:
        raise AssertionError("impl='flash' under autograd did not raise")
    if FA.launches != n0:
        raise AssertionError("impl='flash' under autograd launched the kernel")
    emit(phase="train_flash_guard", raised="ValueError", message=msg[:120])


def phase_train() -> tuple:
    """Phase 16: training on the card.  Returns the kernels' launches over
    (b)-(d), which must be 0: the training path runs none of them, and
    (b)'s numbers (phase 17 reads its ms a step, TF32 and state bytes)."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import uct_backup, uct_select

    t_phase = time.perf_counter()
    held = release()
    worst = train_card_vs_cpu()
    FA.launches = uct_select.launches = uct_backup.launches = 0
    full = train_launcher(configs.get_config(LLAMA), TRAIN_FULL,
                          ("loss", "nll", "grad_norm"), "llama3.2-1b",
                          profile_at=TRAIN_PROFILED, check_moved=True)
    emit(phase="train_full", **full)
    replay = train_replay()
    release()
    mtp = train_launcher(deepseek_cut(0), TRAIN_MTP,
                         ("loss", "nll", "mtp_nll", "grad_norm"),
                         "deepseek-v3 MTP")
    emit(phase="train_mtp", **mtp)
    launches = {"flash_attention": FA.launches,
                "uct_select": uct_select.launches,
                "uct_backup": uct_backup.launches}
    if any(launches.values()):
        raise AssertionError(f"the training path launched kernels: {launches}")
    flash_under_autograd()
    emit(phase="train", seconds=time.perf_counter() - t_phase,
         held_gib_at_start=held, card_vs_cpu_max_rel=worst,
         replay_final_loss_diff=replay["final_loss_diff"], launches=launches)
    return launches, full


# ---------------------------------------------------------------------------
# phase 17: the launch tooling on one card
# ---------------------------------------------------------------------------

LAUNCH_MOE = dict(batch=4, seq=512)     # (b): 2,048 tokens a MoE layer
STATE_TOL = 0.02        # (e): the dry run's state bytes against the card's


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_world():
    """(a) a world of one on the card: init_distributed (NCCL, a free
    localhost port), make_host_mesh's 1x1 (data, model) DeviceMesh;
    all_reduce, all_gather and broadcast of seeded bf16 and f32 tensors
    return them bit for bit and the recorder counts their bytes exactly.
    Returns the mesh."""
    import os

    import torch.distributed as dist

    from repro_torch.launch import collectives
    from repro_torch.launch.distributed_init import init_distributed
    from repro_torch.launch.mesh import make_host_mesh

    os.environ["REPRO_COORDINATOR"] = f"localhost:{free_port()}"
    info = init_distributed()
    mesh = make_host_mesh()
    if tuple(mesh.shape) != (1, 1) or mesh.device_type != torch.device(DEV).type:
        raise AssertionError(f"host mesh {mesh}")
    gen = torch.Generator(device=DEV).manual_seed(17)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        x = randn(gen, (1024, 4096), dtype)
        t = x.clone()
        with collectives.record() as rec:
            dist.all_reduce(t, group=mesh.get_group("model"))
            parts = [torch.empty_like(t)]
            dist.all_gather(parts, t, group=mesh.get_group("data"))
            dist.broadcast(t, src=0)
        torch.cuda.synchronize()
        n = x.numel() * x.element_size()
        want = {"all_reduce": n, "all_gather": n, "reduce_scatter": 0,
                "all_to_all": 0, "broadcast": n, "total": 3 * n}
        exact = torch.equal(t, x) and torch.equal(parts[0], x)
        if not exact or rec.bytes != want:
            raise AssertionError(f"{dtype} collectives: exact {exact}, "
                                 f"recorded {rec.bytes} against {want}")
        out[str(dtype).removeprefix("torch.")] = rec.bytes
    emit(phase="launch_world", **info, mesh=str(mesh), recorded_bytes=out,
         bit_exact=True)
    return mesh


def launch_moe(mesh) -> dict:
    """(b) one MoE layer of mixtral-8x22b and of deepseek-v3-671b at full
    width (bf16 seeded weights; mixtral's freed before deepseek's), B=4 x
    512 tokens: the shard-map path under set_context(mesh, the cell's
    specs.OPTIMIZED_RULES) against the dense path, y and aux identical;
    the recorder counts the model all-reduce's T * d * 2 bytes."""
    from repro_torch import configs
    from repro_torch.launch import collectives, specs
    from repro_torch.models import layers as L
    from repro_torch.models import moe, sharding as sh

    B, S = LAUNCH_MOE["batch"], LAUNCH_MOE["seq"]
    out = {}
    for arch in (MIXTRAL, DEEPSEEK):
        release()
        cfg = configs.get_config(arch)
        rules = specs.OPTIMIZED_RULES[(cfg.name, "train_4k")]
        p = moe.init_moe(cfg, torch.Generator(device=DEV).manual_seed(0))
        x = randn(torch.Generator(device=DEV).manual_seed(1),
                  (B, S, cfg.d_model), L.dt(cfg))
        dense = lambda: moe.moe_forward(cfg, p, x)

        def shard_map():
            sh.set_context(mesh, rules)
            try:
                return moe.moe_forward(cfg, p, x)
            finally:
                sh.set_context(None)

        y0, aux0 = dense()
        with collectives.record() as rec:
            y1, aux1 = shard_map()
        torch.cuda.synchronize()
        T, d = B * S, cfg.d_model
        ar = T * d * y0.element_size()      # the model all-reduce of y
        identical = torch.equal(y0, y1) and torch.equal(aux0, aux1)
        row = dict(arch=cfg.name, tokens=T, E=cfg.n_experts, K=cfg.top_k,
                   rules=repr(rules), identical=identical,
                   max_abs_diff=float((y0.float() - y1.float()).abs().max()),
                   aux=float(aux0), recorded_bytes=rec.bytes,
                   model_all_reduce_bytes=ar,
                   expert_weight_gb=sum(p[k].numel() * p[k].element_size()
                                        for k in ("wi", "wg", "wo")) / 1e9,
                   dense_ms=cuda_time_ms(dense, lambda: None, 3, warm=1),
                   shard_map_ms=cuda_time_ms(shard_map, lambda: None, 3,
                                             warm=1))
        emit(phase="launch_moe", **row)
        if not identical or rec.bytes["all_reduce"] != ar:
            raise AssertionError(f"{cfg.name}: shard-map path identical "
                                 f"{identical}, all_reduce "
                                 f"{rec.bytes['all_reduce']} B, not {ar}")
        out[cfg.name] = row
        del p, x, y0, y1
    release()
    return out


def launch_restore(mesh) -> dict:
    """(c) a seeded tree (llama3.2-1b's f32 embedding, a bf16 matrix, an
    f32 norm) saved and restored with shardings= on the card mesh: every
    leaf a DTensor on the mesh, equal to the saved leaf bit for bit."""
    import tempfile

    from torch.distributed.tensor import DTensor

    from repro_torch import configs
    from repro_torch.distributed.checkpoint import (restore_checkpoint,
                                                    save_checkpoint)
    from repro_torch.models import sharding as sh
    from repro_torch.pytree import tree_leaves

    cfg = configs.get_config(LLAMA)
    gen = torch.Generator(device=DEV).manual_seed(3)
    tree = {"embed": {"tok": randn(gen, (cfg.padded_vocab, cfg.d_model),
                                   torch.float32)},
            "w": randn(gen, (cfg.d_model, cfg.d_ff), torch.bfloat16),
            "norm": randn(gen, (cfg.d_model,), torch.float32)}
    axes = {"embed": {"tok": ("vocab", "embed")}, "w": ("embed", "mlp"),
            "norm": ("embed",)}
    shardings = sh.make_param_shardings(mesh, sh.Rules(), axes, tree)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_restore_") as d:
        save_checkpoint(d, 0, tree)
        t1 = time.perf_counter()
        out, _ = restore_checkpoint(d, 0, tree, shardings)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    leaves = list(zip(tree_leaves(tree), tree_leaves(out)))
    ok = all(isinstance(b, DTensor) and b.device_mesh is mesh
             and b.dtype == a.dtype and torch.equal(b.to_local(), a)
             for a, b in leaves)
    row = dict(leaves=len(leaves), bytes=sum(a.numel() * a.element_size()
                                             for a, _ in leaves),
               dtensors_bit_exact=ok, save_s=t1 - t0, restore_s=t2 - t1,
               placements=[str(b.placements) for _, b in leaves])
    emit(phase="launch_restore", **row)
    if not ok:
        raise AssertionError("restore onto the mesh: not every leaf a DTensor "
                             "equal to the saved one")
    return row


def launch_roofline(train: dict, prefill_ms: float) -> dict:
    """(d) and (e): the dry run (op_costs on meta, state bytes on a 1x1
    mesh) of llama3.2-1b's train step at phase 16(b)'s shape (B=8, S=512,
    bf16, AdamW, naive) and its serve prefill at phase 7's (16 x 2,048,
    flash: 16 reports of the kernel's work); each bound against the time
    this run measured for it (phase 16(b)'s median step, phase 7's
    prefill), the share (bound / measured) and the MFU (model FLOPs over
    ms at 989 TFLOP/s); the train cell's state bytes against the card's
    allocation after the launcher built the same state (within
    STATE_TOL)."""
    from repro_torch import configs
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import MeshShape

    one = MeshShape(("data", "model"), (1, 1))
    out_dir = ROOT / "chiprun_out" / "dryrun_torch"
    cells = {
        "train": (configs.ShapeSpec("train_launcher", TRAIN_FULL["seq"],
                                    TRAIN_FULL["batch"], "train"),
                  train["ms_per_step"], train["tf32"]),
        "serve_prefill": (configs.ShapeSpec("serve_prefill", 2048, 16,
                                            "prefill"), prefill_ms, False)}
    rows = {}
    for label, (shape, ms, tf32) in cells.items():
        rec = dryrun.run_cell(LLAMA, None, False, shape=shape, mesh=one,
                              out_dir=out_dir)
        if rec["status"] != "ok":
            raise AssertionError(f"dry run of {label}: {rec.get('error')}")
        costs = dict(rec["flops_by_dtype"], bytes=rec["bytes_global"])
        b = roofline.bound_s(costs, tf32=tf32)
        rows[label] = dict(
            shape=f"B={shape.global_batch} S={shape.seq_len} "
                  f"{configs.get_config(LLAMA).dtype}, {rec['impl']}",
            tf32=tf32, **rec["flops_by_dtype"], bytes=rec["bytes_global"],
            kernel_reports=rec["kernel_reports"],
            kernel_reported_flops=rec["kernel_reported_flops"],
            bound_ms=1e3 * b["bound_s"], bound_by=b["bound_by"],
            compute_ms=1e3 * b["compute_s"], memory_ms=1e3 * b["memory_s"],
            measured_ms=ms, share=1e3 * b["bound_s"] / ms,
            model_flops=rec["model_flops"],
            mfu=rec["model_flops"] / (ms / 1e3 * H100_BF16_OPS_PER_S),
            count_s=rec["count_s"], state_bytes=rec["state_bytes_device"])
        emit(phase="launch_roofline", cell=label, **rows[label])
    want, got = rows["train"]["state_bytes"], train["state_bytes"]
    rel = abs(got - want) / want
    emit(phase="launch_state", dryrun_state_bytes=want,
         card_state_bytes=got, rel_diff=rel, tol=STATE_TOL)
    if not rel <= STATE_TOL:
        raise AssertionError(f"dry run's state {want} B against the card's "
                             f"{got} B: {rel:.3%} > {STATE_TOL:.0%}")
    if rows["serve_prefill"]["kernel_reports"] != configs.get_config(
            LLAMA).n_layers:
        raise AssertionError("the prefill's count holds "
                             f"{rows['serve_prefill']['kernel_reports']} "
                             "flash reports, not one a layer")
    return rows


def phase_launch(train: dict, prefill_ms: float) -> dict:
    """Phase 17: the launch tooling on the card.  Returns the kernels'
    launches over the phase (0: the roofline counts flash on meta,
    through its reports) and the roofline rows."""
    import torch.distributed as dist

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import uct_backup, uct_select

    t_phase = time.perf_counter()
    FA.launches = uct_select.launches = uct_backup.launches = 0
    mesh = launch_world()
    try:
        moe_rows = launch_moe(mesh)
        restore = launch_restore(mesh)
        rows = launch_roofline(train, prefill_ms)
    finally:
        dist.destroy_process_group()
    launches = {"flash_attention": FA.launches,
                "uct_select": uct_select.launches,
                "uct_backup": uct_backup.launches}
    emit(phase="launch", seconds=time.perf_counter() - t_phase,
         launches=launches, moe_identical={k: v["identical"]
                                           for k, v in moe_rows.items()},
         restore_bit_exact=restore["dtensors_bit_exact"],
         shares={k: v["share"] for k, v in rows.items()},
         mfu={k: v["mfu"] for k, v in rows.items()})
    return {"launches": launches, "rows": rows}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tests"))     # tree_cases: seeded trees
    from repro_torch import configs
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    progress(1)
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

    progress(2)
    n_cases = phase_kernels()
    emit(phase="kernels", cases=n_cases, mismatches=0)
    progress(3)
    mc, launches, steps = phase_main_path()
    progress(4)
    phase_timed()
    kernels = kernel_rows(mc, launches)
    progress(5)
    phase_flash()
    progress(6)
    phase_lm_prefill()
    progress(7)
    serve_launches, serve_prefill_ms = phase_serve()
    flash = flash_row()
    progress(8)
    lm_launches = phase_mcts_lm(configs.get_config(LLAMA))
    kernels.append(dict(flash, launches=lm_launches["flash_attention"],
                        launches_serve=serve_launches))
    progress(9)
    serving = phase_serving(mc)
    progress(10)
    fused_launches = phase_fused(serving["want"])
    progress(11)
    overlap_launches = phase_overlap(serving["want"])
    progress(12)
    gomoku = phase_gomoku()
    progress(13)
    recurrent = phase_recurrent()
    kernels[2]["launches_recurrentgemma"] = {
        "serve_prefill": recurrent["serve"][RGEMMA],
        "f32_prefill": recurrent["prefill_f32"]}
    kernels[2]["launches_mamba2_mcts"] = recurrent["mcts"]["flash_attention"]
    progress(14)
    moe = phase_moe()
    kernels[2]["at_mixtral_serve"] = moe["flash_row"]
    kernels[2]["launches_mixtral_serve"] = moe["serve"][MIXTRAL]
    kernels[2]["launches_deepseek_serve"] = moe["serve"][DEEPSEEK]
    kernels[2]["launches_mixtral_f32_prefill"] = moe["prefill_f32"]
    kernels[2]["launches_mixtral_mcts"] = moe["mcts"]["flash_attention"]
    progress(15)
    encdec = phase_encdec()
    kernels[2]["at_whisper_encoder"] = encdec["rows"]["encoder"]
    kernels[2]["at_whisper_cross"] = encdec["rows"]["cross"]
    kernels[2]["launches_whisper_serve"] = encdec["serve"][WHISPER]
    kernels[2]["launches_paligemma_serve"] = encdec["serve"][PALIGEMMA]
    kernels[2]["launches_whisper_f32_prefill"] = encdec["prefill_f32"]
    progress(16)
    train_launches, train_full = phase_train()
    progress(17)
    launch = phase_launch(train_full, serve_prefill_ms)
    for row in kernels:
        row["launches_training"] = train_launches[row["name"]]
        row["launches_launch"] = launch["launches"][row["name"]]
    kernels[2]["reports_launch_prefill"] = \
        launch["rows"]["serve_prefill"]["kernel_reports"]
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
        row["launches_gomoku"] = {k: gomoku[k][row["name"]] for k in (
            "main", "run_step", "serving", "overlap")}
        row["gomoku_path_device_ms"] = gomoku["device_ms"].get(
            row["name"] + "_kernel")
        row["launches_mamba2_mcts"] = recurrent["mcts"][row["name"]]
        row["launches_mixtral_mcts"] = moe["mcts"][row["name"]]
    emit(phase="total", seconds=round(time.perf_counter() - t_start, 3))
    print(gpu, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
