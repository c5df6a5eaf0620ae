"""The CUDA kernels against their plain torch versions, on the card.

Needs a CUDA device (and nvcc, which builds the kernels at first use);
elsewhere every test here skips with its reason.  Imports only torch,
numpy and repro_torch, so it runs where jax is not installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Trees are grown with the port's plain ops on the CPU from a numpy seed,
then copied to the card twice: one copy goes through the kernels, the
other through the plain versions, and every array must be identical;
the Selection kernel also on its hazard cases (tests/tree_cases.py).
The serving path (repro_torch.service.SearchClient, executor="cuda") is
held to the numpy oracle on a short G=16 stream with sessions open, also
with the fused K-superstep dispatch; Node Insertion and a fused submit
must not synchronise, the fused dispatch's CUDA graph must equal the
eager superstep body on every escape, and a retired pool or a released
executor must free its arena (and its graph).  The re-root kernel against
its plain twin at Pong's and Gomoku's full X (tests/tree_cases.py trees),
every arena tensor kept at its address, and a fused pool re-rooting on
the card against the numpy oracle.
The flash-attention kernel is held to its plain version at the JAX flash
test's tolerances (f32 2e-5, bf16 2e-2); in bf16 also to the plain version
run in f32 on the same inputs, within one bf16 rounding of the output,
over every head dim, the LM paths' short rows, windows, non-causal
Sq != Sk, fused-projection views, recurrentgemma-9b's local MQA
(Hkv=1, dh=256, window 2048) and whisper-small's non-causal encoder and
cross-attention (Sk = 1,500, not a multiple of the key tile); a
misaligned bf16 stride raises.
The SSD and RG-LRU mixers (plain torch) on the card against the CPU, at
SMOKE width and one full-width layer, and a reused batcher slot over both
recurrent archs against a fresh batcher.  The MoE dispatch on the card
against the CPU at the published E and K (every integer identical), and
the MoE layer, MLA (prefill, decode decompressed and absorbed) and the
whole SMOKE mixtral / deepseek-v3 on the card against the CPU; the SMOKE
whisper-small and paligemma-3b's prefill (frames, patches) and decode on
the card against the CPU.  Three train steps of eight SMOKE archs on the
card against the CPU (no kernel launches), and impl="flash" under
autograd raising before it launches.  The straggler-masked superstep
(tests/test_mcts_system.py) on the cuda executor against the reference.
The launch tooling on an NCCL world of one: collectives bit for bit with
their recorded bytes, the SMOKE MoE shard-map path identical to dense on
the card's 1x1 mesh, and a restore onto that mesh as DTensors.  The LM
pool's batched admission at granite-4.0-h-small's SMOKE shape in bf16:
its B-row graphs against the eager B-row extend and a padded group
against a full one, bit for bit, and no dummy row reaching a slot.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import fixedpoint as fx
from repro_torch.core import intree
from repro_torch.core.tree import NULL, TreeConfig, from_numpy, init_arena, to_numpy
from repro_torch.envs import BanditTreeEnv, BanditValueBackend
from repro_torch.kernels import uct_backup, uct_select
from repro_torch.kernels import flash_attention as FA
import tree_cases

SWEEP = [   # tests/test_kernels_uct.py TREE_SWEEP
    TreeConfig(X=64, F=2, D=3),
    TreeConfig(X=128, F=4, D=5),
    TreeConfig(X=128, F=6, D=4, vl_mode="constant", vl_const=0.5),
    TreeConfig(X=256, F=36, D=3, score_fn="puct", leaf_mode="unexpanded",
               expand_all=True),
]
TREE_FIELDS = ("child", "edge_N", "edge_W", "edge_VL", "edge_P", "node_N",
               "node_O", "num_expanded", "num_actions", "terminal", "size")


def need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ for sm_90a")


def grown_arena(cfg, G, supersteps, rng) -> dict:
    """G trees grown on the CPU with the plain ops and random values."""
    arena = init_arena(cfg, G, device="cpu")
    act = torch.ones(G, dtype=torch.bool)
    p = 4
    for _ in range(supersteps):
        sel = intree.select_arena(cfg, arena, act, p)
        new = intree.insert_arena(cfg, arena, act, sel)
        ins = new != NULL
        na = torch.where(ins, torch.tensor(cfg.F), 0)
        intree.finalize_arena(arena, new.reshape(G, -1), na.reshape(G, -1),
                              torch.zeros_like(new).reshape(G, -1))
        sim = torch.where(sel.expand_action >= 0, new[:, :, 0], sel.leaves)
        vals = fx.encode(torch.tensor(rng.uniform(-1, 1, (G, p)), dtype=torch.float32))
        intree.backup_arena(cfg, arena, act, sel, sim, vals)
    return to_numpy(arena)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", SWEEP, ids=lambda c: f"F{c.F}-D{c.D}-{c.vl_mode}-{c.score_fn}")
@pytest.mark.parametrize("p", [1, 4, 16])
def test_kernels_match_plain(cfg, p):
    need_cuda()
    G = 4
    rng = np.random.RandomState(p)
    arrays = grown_arena(cfg, G, 6, rng)
    active = torch.tensor([1, 0, 1, 1], dtype=torch.int32, device="cuda")
    tk, tp = from_numpy(arrays, "cuda"), from_numpy(arrays, "cuda")
    sk = uct_select.select_arena(cfg, tk, active, p)
    sp = uct_select.select_arena_plain(cfg, tp, active, p)
    for k in intree.SEL_FIELDS:
        assert torch.equal(getattr(sk, k), getattr(sp, k)), k
    for k in TREE_FIELDS:
        assert torch.equal(getattr(tk, k), getattr(tp, k)), k

    intree.insert_arena(cfg, tk, active, sk)
    new = intree.insert_arena(cfg, tp, active, sp)
    sim = torch.where(sp.expand_action >= 0, new[:, :, 0], sp.leaves).to(torch.int32)
    vals = torch.tensor(rng.randint(-65536, 65537, (G, p)), dtype=torch.int32,
                        device="cuda")
    drop = torch.tensor((rng.rand(G, p) < 0.3).astype(np.int32), device="cuda")
    for alternating in (False, True):
        for dropped in (None, drop):
            bk, bp = from_numpy(to_numpy(tk), "cuda"), from_numpy(to_numpy(tp), "cuda")
            uct_backup.backup_arena(cfg, bk, active, sk, sim, vals, alternating, dropped)
            uct_backup.backup_arena_plain(cfg, bp, active, sp, sim, vals,
                                          alternating, dropped)
            for k in TREE_FIELDS:
                assert torch.equal(getattr(bk, k), getattr(bp, k)), k


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(tree_cases.HAZARDS))
def test_select_kernel_matches_plain_on_hazards(name):
    """The Selection kernel's hazards (tests/tree_cases.py): in-flight counts
    non-zero at launch, p = 48 workers over one warp's 32 lanes, ln-table
    entries at the cap 2X+3 and at its low end, a fresh root whose
    children all tie at FX_FORCE_EXPLORE, and the Gomoku width (X=48,000,
    Fp=64, D=5, puct, expand-all), one slot each."""
    need_cuda()
    cfg, arrays, p = tree_cases.hazard(name)
    arrays = tree_cases.as_slot(arrays)
    active = torch.ones(1, dtype=torch.int32, device="cuda")
    tk, tp = from_numpy(arrays, "cuda"), from_numpy(arrays, "cuda")
    sk = uct_select.select_arena(cfg, tk, active, p)
    sp = uct_select.select_arena_plain(cfg, tp, active, p)
    for k in intree.SEL_FIELDS:
        assert torch.equal(getattr(sk, k), getattr(sp, k)), k
    for k in TREE_FIELDS:
        assert torch.equal(getattr(tk, k), getattr(tp, k)), k


@pytest.mark.cuda
def test_select_kernel_refuses_p_past_shared_memory():
    """The kernel keeps 20 B a worker in shared memory: the wrapper refuses
    p past the 227 KB (232,448 B) a block may have before launching, and
    does not count it; the largest p that fits runs."""
    need_cuda()
    cfg = SWEEP[0]
    arena = init_arena(cfg, 1, device="cuda")
    act = torch.ones(1, dtype=torch.int32, device="cuda")
    p_max = 232_448 // 20
    n = uct_select.launches
    with pytest.raises(ValueError, match=f"p={p_max + 1} needs .* 227 KB"):
        uct_select.select_arena(cfg, arena, act, p_max + 1)
    assert uct_select.launches == n
    sel = uct_select.select_arena(cfg, arena, act, p_max)
    torch.cuda.synchronize()
    assert uct_select.launches == n + 1
    # a fresh root is every worker's leaf: its F actions go to the first F
    assert sel.expand_action[0, :cfg.F].tolist() == list(range(cfg.F))
    assert int(sel.n_insert.sum()) == cfg.F


@pytest.mark.cuda
def test_launch_counters_count_kernel_launches_only():
    need_cuda()
    cfg = SWEEP[1]
    arena = init_arena(cfg, 2, device="cuda")
    act = torch.ones(2, dtype=torch.int32, device="cuda")
    n_sel, n_bak = uct_select.launches, uct_backup.launches
    sel = uct_select.select_arena(cfg, arena, act, 3)
    uct_select.select_arena_plain(cfg, from_numpy(to_numpy(arena), "cuda"), act, 3)
    z = torch.zeros((2, 3), dtype=torch.int32, device="cuda")
    uct_backup.backup_arena(cfg, arena, act, sel, sel.leaves, z)
    torch.cuda.synchronize()
    assert (uct_select.launches, uct_backup.launches) == (n_sel + 1, n_bak + 1)


# -- the re-root kernel (kernels.reroot) ------------------------------------

def reroot_cases(shape: str):
    """(config, tree, new roots) at the configuration's full X: seeded
    random valid trees of X / 4 and of up to X nodes; as new roots, the
    first six children of the root (two in the larger tree), the deepest
    leaf and the root itself."""
    cfg = TreeConfig(**getattr(tree_cases, shape))
    rng = np.random.RandomState(11)
    out = []
    for n in (cfg.X // 4, cfg.X):
        t = tree_cases.random_tree(cfg, n, rng)
        kids = [int(c) for c in t["child"][0] if c != NULL]
        size = int(t["size"])
        leaves = np.flatnonzero((t["child"][:size] == NULL).all(axis=1))
        leaf = int(leaves[np.argmax(t["node_depth"][leaves])])
        out.append((cfg, t, kids[:6 if n < cfg.X else 2] + [leaf, 0]))
    return out


def reroot_both(cfg, arena_cpu, arena_dev, g, new_root):
    """One re-root of slot g through the twin (CPU arena) and the kernel
    (card arena); returns both scratches."""
    from repro_torch.kernels import reroot as kreroot

    sc_cpu = kreroot.Scratch(cfg.X, cfg.Fp, "cpu")
    sc_dev = kreroot.Scratch(cfg.X, cfg.Fp, "cuda")
    for arena, sc in ((arena_cpu, sc_cpu), (arena_dev, sc_dev)):
        kreroot.reroot(arena, g, new_root, sc)
        kreroot.write(arena, g, sc)
    torch.cuda.synchronize()
    return sc_cpu, sc_dev


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["PONG", "GOMOKU"])
def test_reroot_kernel_matches_twin_at_full_width(shape):
    """The kernel against its plain twin at the configuration's full X,
    three slots, re-rooting slot 1: every arena array identical (the
    other slots untouched), the kept ids and old2new identical, every
    arena tensor at its address, four launches counted a re-root (the
    row read, then passes 1-3)."""
    need_cuda()
    from repro_torch.kernels import reroot as kreroot

    for cfg, tree, roots in reroot_cases(shape):
        other = tree_cases.random_tree(cfg, cfg.X // 8,
                                       np.random.RandomState(5))
        stacked = {k: np.stack([other[k], tree[k], other[k]])
                   if k != "log_table" else tree[k] for k in tree}
        for new_root in roots:
            arena_cpu = from_numpy(stacked, "cpu")
            arena_dev = from_numpy(stacked, "cuda")
            ptrs = {k: getattr(arena_dev, k).data_ptr() for k in
                    vars(arena_dev)}
            n0 = kreroot.launches
            sc_dev = kreroot.Scratch(cfg.X, cfg.Fp, "cuda")
            row = kreroot.root_row(arena_dev, 1, sc_dev)
            assert row[0] == 0 and (row[1] == tree["child"][0]).all()
            assert (row[2] == tree["edge_N"][0]).all()
            sc_cpu, sc_dev = reroot_both(cfg, arena_cpu, arena_dev, 1,
                                         new_root)
            assert kreroot.launches - n0 == 4
            assert {k: getattr(arena_dev, k).data_ptr()
                    for k in vars(arena_dev)} == ptrs
            got, want = to_numpy(arena_dev), to_numpy(arena_cpu)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k],
                                              err_msg=f"{shape} {new_root} {k}")
            for k in stacked:   # slots 0 and 2 as they were
                if k != "log_table":
                    np.testing.assert_array_equal(got[k][[0, 2]],
                                                  stacked[k][[0, 2]])
            n = int(sc_cpu.order[0])
            assert int(got["size"][1]) == n
            np.testing.assert_array_equal(sc_dev.order[:1 + n].cpu().numpy(),
                                          sc_cpu.order[:1 + n].numpy())
            np.testing.assert_array_equal(sc_dev.old2new.cpu().numpy(),
                                          sc_cpu.old2new.numpy())
            np.testing.assert_array_equal(kreroot.read_order(sc_dev),
                                          sc_cpu.order[1:1 + n].numpy())


@pytest.mark.cuda
def test_fused_pool_reroots_on_the_card():
    """SearchClient(supersteps_per_dispatch=4) on the card with subtree
    reuse: the stream equals the numpy oracle's (held to the JAX package
    on the CPU, tests/test_torch_reroot.py), no commit reads a whole
    tree but the kept ones, every re-rooting commit counts as a device
    re-root and launched the kernel's four launches."""
    need_cuda()
    from repro_torch.core.executor import TorchExecutor
    from repro_torch.kernels import reroot as kreroot
    from repro_torch.service import SearchClient, SearchRequest

    def run(executor, **kw):
        cl = SearchClient(BanditTreeEnv(fanout=4, terminal_depth=10),
                          BanditValueBackend(), G=8, p=4, executor=executor,
                          default_cfg=TreeConfig(X=2048, F=4, D=6),
                          device="cuda", metrics=True, **kw)
        rng = np.random.RandomState(3)
        try:
            hs = [cl.submit(SearchRequest(
                uid=i, seed=int(rng.randint(1000)),
                budget=int(rng.randint(3, 9)), moves=int(rng.randint(2, 5)),
                keep_tree=i % 4 == 0)) for i in range(20)]
            return {h.uid: h.result() for h in hs}, cl
        finally:
            cl.close()

    snapshot = TorchExecutor.slot_snapshot
    reads = []
    TorchExecutor.slot_snapshot = lambda ex, g: reads.append(g) or snapshot(ex, g)
    try:
        n0 = kreroot.launches
        got, cl = run("cuda", supersteps_per_dispatch=4)
        launched = kreroot.launches - n0
    finally:
        TorchExecutor.slot_snapshot = snapshot
    want, _ = run("reference")
    assert cl.stats.fused_dispatches > 0 and cl.stats.fused_escape_commit > 0
    for uid, b in want.items():
        a = got[uid]
        assert (a.actions, a.rewards, a.supersteps) == \
            (b.actions, b.rewards, b.supersteps), uid
        for va, vb in zip(a.visit_counts, b.visit_counts, strict=True):
            np.testing.assert_array_equal(va, vb)
        for k in (b.tree_snapshot or {}):
            np.testing.assert_array_equal(a.tree_snapshot[k],
                                          b.tree_snapshot[k], err_msg=k)
    assert len(reads) == sum(r.tree_snapshot is not None
                             for r in want.values())
    series = cl.registry.snapshot()["service_reroots_total"]
    reroots = sum(v for k, v in series.items() if 'path="device"' in k)
    commits = sum(len(r.actions) for r in want.values())
    assert reroots == sum(len(r.actions) - 1 for r in want.values()) > 0
    # a row read a commit that keeps no tree, passes 1-3 a re-root
    assert launched == commits - len(reads) + 3 * reroots


FLASH_CASES = [  # B, Sq, Sk, H, Hkv, dh, causal, window
    (1, 2, 2, 32, 8, 64, True, None),        # phase 8's shortest forward
    (1, 7, 7, 32, 8, 64, True, None),        # one partial query tile (S < 64)
    (1, 43, 43, 32, 8, 64, True, None),      # phase 8's longest forward
    (1, 200, 200, 2, 1, 16, True, None),
    (2, 130, 130, 4, 2, 32, True, 40),       # window inside one tile
    (2, 384, 384, 8, 2, 128, True, 64),
    (2, 70, 130, 4, 2, 32, False, None),     # non-causal, Sq < Sk
    (1, 190, 90, 4, 1, 64, False, None),     # non-causal, Sq > Sk
    (1, 300, 520, 4, 4, 256, False, 100),
    (1, 2048, 2048, 16, 1, 256, True, 2048),  # recurrentgemma-9b's local MQA
    (1, 43, 43, 48, 8, 128, True, 4096),     # mixtral-8x22b: MCTS forwards
    (4, 512, 512, 48, 8, 128, True, 4096),   # and chip_smoke's f32 prefill
    (2, 1500, 1500, 12, 12, 64, False, None),  # whisper-small: its encoder,
    (2, 384, 1500, 12, 12, 64, False, None),  # cross-attention over the
    (2, 384, 384, 12, 12, 64, True, None),    # frames, decoder self-attention
]


def qkv(shapes, dtype, seed):
    rng = np.random.RandomState(seed)
    return [torch.tensor(rng.randn(*shape), dtype=torch.float32)
            .to(device="cuda", dtype=dtype) for shape in shapes]


def check_flash(q, k, v, causal, window):
    n = FA.launches
    out = FA.flash_attention(q, k, v, causal=causal, window=window)
    ref = FA.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert FA.launches == n + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    tol = 2e-2 if q.dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    if q.dtype == torch.bfloat16:
        wide = FA.flash_attention_plain(q.float(), k.float(), v.float(),
                                        causal=causal, window=window)
        atol, rtol = FA.BF16_ROUND_TOL
        torch.testing.assert_close(out.float(), wide, atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_kernel_matches_plain(case, dtype):
    need_cuda()
    B, Sq, Sk, H, Hkv, dh, causal, window = case
    q, k, v = qkv(((B, Sq, H, dh), (B, Sk, Hkv, dh), (B, Sk, Hkv, dh)),
                  dtype, dh)
    check_flash(q, k, v, causal, window)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_kernel_reads_fused_projection_views(dtype):
    """q, k, v as [B,S,H,dh] views of one fused [B,S,(H+2Hkv)*dh]
    projection: strided, head_dim contiguous, 16-byte aligned."""
    need_cuda()
    B, S, H, Hkv, dh = 2, 100, 8, 2, 64
    (fused,) = qkv(((B, S, H + 2 * Hkv, dh),), dtype, 5)
    q, k, v = fused[:, :, :H], fused[:, :, H:H + Hkv], fused[:, :, H + Hkv:]
    assert not q.is_contiguous() and not k.is_contiguous()
    check_flash(q, k, v, True, None)


@pytest.mark.cuda
def test_flash_kernel_takes_the_configured_scale():
    """granite-4.0-h-small's prefill shape (B=1, S=4,096, 32 query heads
    over 8 KV heads of 128, bf16) at its attention_multiplier 1/128, not
    1/sqrt(128): the kernel against blockwise_attention at that scale,
    computed in f32 on the same bf16 inputs (half a bf16 ulp of rounding
    on top of the f32 tolerance, FA.BF16_ROUND_TOL)."""
    need_cuda()
    from repro_torch.models.attention import blockwise_attention

    q, k, v = qkv(((1, 4096, 32, 128), (1, 4096, 8, 128), (1, 4096, 8, 128)),
                  torch.bfloat16, 9)
    n = FA.launches
    out = FA.flash_attention(q, k, v, causal=True, scale=1 / 128)
    want = blockwise_attention(q.float(), k.float(), v.float(), causal=True,
                               scale=1 / 128)
    torch.cuda.synchronize()
    assert FA.launches == n + 1
    atol, rtol = FA.BF16_ROUND_TOL
    torch.testing.assert_close(out.float(), want, atol=atol, rtol=rtol)
    default = FA.flash_attention(q, k, v, causal=True)
    assert (default.float() - want).abs().max() > 100 * atol


@pytest.mark.cuda
def test_flash_kernel_refuses_misaligned_bf16_stride():
    """A seq stride of 2*64 + 4 elements (264 bytes) is not a multiple of
    16 bytes: the bf16 kernel's TMA cannot read it, so the wrapper raises
    naming that stride and launches nothing."""
    need_cuda()
    B, S, H, dh = 1, 16, 2, 64
    (flat,) = qkv(((B, S, H * dh + 4),), torch.bfloat16, 6)
    q = flat[:, :, :H * dh].unflatten(2, (H, dh))
    n = FA.launches
    with pytest.raises(ValueError, match=r"q: seq stride 132 elements"):
        FA.flash_attention(q, q, q, causal=True)
    assert FA.launches == n


# -- the serving path (repro_torch.service) on the card -------------------

def serving_stream(executor, G=16, p=4, K=1, **kw):
    """A short seeded stream through SearchClient on the card: 24
    requests over two shape classes (weighted-queue-depth: cross-pool
    fused Simulation), compaction sessions below half occupancy, one
    cancel, one deadline eviction.  With the fused dispatch (K > 1) a
    tick runs up to K supersteps, so request 5 is cancelled after its
    first move instead of after two ticks (a point that is the same
    under any grouping of supersteps).  Keyword arguments override the
    client's settings.  Returns ({uid: SearchResult}, client stats, xpool
    batches)."""
    from repro_torch.envs import BanditTreeEnv, BanditValueBackend
    from repro_torch.service import SearchClient, SearchRequest

    cfgs = [TreeConfig(X=512, F=4, D=6), TreeConfig(X=256, F=4, D=6)]
    rng = np.random.RandomState(0)
    opts = dict(policy="weighted-queue-depth", compact_threshold=0.5,
                expansion="vector", supersteps_per_dispatch=K)
    opts.update(kw)
    cl = SearchClient(BanditTreeEnv(fanout=4, terminal_depth=10),
                      BanditValueBackend(), G=G, p=p, executor=executor,
                      device="cuda", **opts)
    try:
        reqs = [SearchRequest(
            uid=i, seed=int(rng.randint(1000)), budget=int(rng.randint(3, 9)),
            moves=int(rng.randint(1, 3)), keep_tree=i % 3 == 0,
            cfg=cfgs[i % 2]) for i in range(24)]
        if K > 1:
            reqs[5].moves = 2
        hs = [cl.submit(r) for r in reqs]
        hs.append(cl.submit(SearchRequest(uid=24, seed=5, budget=50,
                                          cfg=cfgs[0]), deadline_supersteps=4))
        if K > 1:
            assert cl.run_until(lambda c: len(c.core.move_log.get(5, [])) >= 1)
        else:
            cl.poll(2)
        assert hs[5].cancel()
        done = {h.uid: h.result() for h in hs}
        return done, cl.stats, cl.core.xpool_batches
    finally:
        cl.close()


@pytest.mark.cuda
def test_serving_stream_cuda_matches_reference():
    """SearchClient with executor="cuda" (one launch of each tree kernel
    per pool tick, sessions at pow2 widths G < 16) gives the numpy
    oracle's SearchResults, request for request."""
    need_cuda()
    n_sel, n_bak = uct_select.launches, uct_backup.launches
    got, stats, xpool = serving_stream("cuda")
    assert uct_select.launches - n_sel == stats.supersteps
    assert uct_backup.launches - n_bak == stats.supersteps
    want, _, xpool_ref = serving_stream("reference")
    assert xpool == xpool_ref > 0
    assert stats.session_gathers >= 1 and stats.session_scatters >= 1
    for uid, b in want.items():
        a = got[uid]
        assert (a.actions, a.rewards, a.supersteps, a.cancelled,
                a.deadline_evicted) == (b.actions, b.rewards, b.supersteps,
                                        b.cancelled, b.deadline_evicted), uid
        for va, vb in zip(a.visit_counts, b.visit_counts):
            np.testing.assert_array_equal(va, vb)
        for k in (b.tree_snapshot or {}):
            np.testing.assert_array_equal(a.tree_snapshot[k],
                                          b.tree_snapshot[k], err_msg=k)


@pytest.mark.cuda
def test_insert_makes_no_host_sync():
    """Node Insertion queues its work and returns: under CUDA's sync
    debug mode "error" neither insert_arena nor the executor's
    insert_dev (numpy mask, non-blocking upload) synchronises; the one
    blocking read is insert_host."""
    need_cuda()
    from repro_torch.core.executor import CudaExecutor

    cfg = SWEEP[1]
    ex = CudaExecutor(cfg, 4, device="cuda")
    active = np.array([True, False, True, True])
    sel = ex.selection(active, 4)
    act = torch.tensor(active, device="cuda")
    copy = from_numpy(to_numpy(ex.trees), "cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dev = ex.insert_dev(active, sel)
        intree.insert_arena(cfg, copy, act, sel)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert isinstance(dev, torch.Tensor) and dev.is_cuda
    assert ex.insert_host(dev).shape == (4, 4, cfg.Fp)


@pytest.mark.cuda
def test_retire_frees_the_cuda_arena():
    """A retired pool gives its arena's memory back to the allocator."""
    need_cuda()
    from repro_torch.envs import BanditTreeEnv, BanditValueBackend
    from repro_torch.service import ArenaPool, SearchRequest

    cfg = TreeConfig(X=4096, F=4, D=6)
    pool = ArenaPool(cfg, BanditTreeEnv(fanout=4, terminal_depth=10),
                     BanditValueBackend(), G=4, p=4, device="cuda")
    pool.submit(SearchRequest(uid=0, seed=1, budget=2))
    pool.run()
    arena = sum(t.numel() * t.element_size() for t in vars(pool.exec.trees).values())
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    assert pool.retire()
    after = torch.cuda.memory_allocated()
    assert before - after >= arena
    pool.close()


# -- the fused K-superstep dispatch (repro_torch.core.fused) on the card --

class _PartialEnv(BanditTreeEnv):
    """BanditTreeEnv whose device twin refuses transitions from depth >= 2
    leaves (the expand escape; tests/test_executor_matrix.py)."""

    def resolvable_device(self, states, actions):
        return states[..., 0] < 2


FUSED_CASES = {   # name: (tree config, budgets, partial env, escape)
    "ran_k": (TreeConfig(X=512, F=4, D=6), [100] * 4, False, "ran_k"),
    "budget-commit": (TreeConfig(X=512, F=4, D=6), [100, 3, 100, 7], False,
                      "commit"),
    "arena-full": (TreeConfig(X=40, F=4, D=6), [100] * 4, False, "commit"),
    "expand": (TreeConfig(X=512, F=4, D=6), [100] * 4, True, "expand"),
}
FUSED_ACTIVE = np.array([True, True, False, True])


def fused_start(cfg, partial):
    """4 slots grown 3 supersteps on the CPU (plain fused body), their ST
    image, env and sim."""
    from repro_torch.core import fused

    env = (_PartialEnv if partial else BanditTreeEnv)(fanout=4, terminal_depth=10)
    sim = BanditValueBackend()
    arena = init_arena(cfg, 4, root_num_actions=4, device="cpu")
    states = np.zeros((4, cfg.X, 8), np.float32)
    for r in range(4):
        states[r, 0] = env.initial_state(r)
    _, d = fused.run_supersteps(cfg, "faithful", arena, np.ones(4, bool), 4,
                                1, env, sim, states, np.full(4, 100, np.int32),
                                False)
    for r in range(4):
        lo, rows = d.written(r)
        states[r, lo: lo + len(rows)] = rows
    return to_numpy(arena), states, env, sim


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_graph_matches_eager_body(case):
    """The cuda executor's fused dispatch (one captured CUDA graph of the
    superstep body, replayed) equals the plain (faithful) eager body on
    the card from the same arena, bit for bit, on every escape; each
    replay launches each tree kernel once."""
    need_cuda()
    from repro_torch.core import fused
    from repro_torch.core.executor import CudaExecutor

    cfg, budgets, partial, escape = FUSED_CASES[case]
    arrays, states, env, sim = fused_start(cfg, partial)
    budgets = np.asarray(budgets, np.int32)
    ex = CudaExecutor(cfg, 4, device="cuda", _trees=from_numpy(arrays, "cuda"))
    n_sel, n_bak = uct_select.launches, uct_backup.launches
    got = ex.run_supersteps(FUSED_ACTIVE, 4, 16, env, sim, states, budgets, False)
    assert ex._fused[0].graph is not None
    # the capture's warm-up launched each kernel once, predicated off
    assert uct_select.launches - n_sel == got.replays + 1
    assert uct_backup.launches - n_bak == got.replays + 1
    plain = fused.FusedProgram(cfg, "faithful", from_numpy(arrays, "cuda"), 4,
                               env, sim, False)
    want = plain.collect(plain.submit(FUSED_ACTIVE, 16, states, budgets))
    assert got.escape == want.escape == escape
    assert got.n == want.n
    for k in ("size_pre", "sizes", "states_lo"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    for r in np.flatnonzero(FUSED_ACTIVE):
        np.testing.assert_array_equal(got.written(r)[1], want.written(r)[1])
    if escape == "expand":
        for k in intree.SEL_FIELDS:
            np.testing.assert_array_equal(got.sel_host[k], want.sel_host[k])
        np.testing.assert_array_equal(got.new_nodes, want.new_nodes)
    a, b = to_numpy(ex.trees), to_numpy(plain.trees)
    for k in TREE_FIELDS:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.cuda
def test_fused_submit_makes_no_host_sync():
    """With its graph captured, run_supersteps_submit queues the upload,
    the replays and the read-back without a sync: it runs under CUDA's
    sync debug mode "error"; collect is the one read."""
    need_cuda()
    from repro_torch.core.executor import CudaExecutor

    cfg, budgets, _, _ = FUSED_CASES["ran_k"]
    arrays, states, env, sim = fused_start(cfg, False)
    ex = CudaExecutor(cfg, 4, device="cuda", _trees=from_numpy(arrays, "cuda"))
    args = (FUSED_ACTIVE, 4, 4, env, sim, states, np.asarray(budgets, np.int32),
            False)
    first = ex.run_supersteps(*args)            # captures the graph
    states2 = states.copy()
    for r in np.flatnonzero(FUSED_ACTIVE):
        lo, rows = first.written(r)
        states2[r, lo: lo + len(rows)] = rows
    args = args[:5] + (states2,) + args[6:]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pend = ex.run_supersteps_submit(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    d = ex.run_supersteps_collect(pend)
    assert d.n == 4 and d.escape == "ran_k"


@pytest.mark.cuda
def test_released_executor_drops_its_graph():
    """release() drops the cached FusedProgram with its CUDA graph, its
    ST buffer and the arena: the allocator gets all of it back."""
    need_cuda()
    import gc
    import weakref

    from repro_torch.core.executor import CudaExecutor

    cfg, budgets, _, _ = FUSED_CASES["ran_k"]
    arrays, states, env, sim = fused_start(cfg, False)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    ex = CudaExecutor(cfg, 4, device="cuda", _trees=from_numpy(arrays, "cuda"))
    ex.run_supersteps(FUSED_ACTIVE, 4, 4, env, sim, states,
                      np.asarray(budgets, np.int32), False)
    prog = weakref.ref(ex._fused[0])
    graph = weakref.ref(ex._fused[0].graph)
    held = torch.cuda.memory_allocated() - base
    arena = sum(t.numel() * t.element_size() for t in vars(ex.trees).values())
    buf = ex._fused[0].states
    st = buf.numel() * buf.element_size()
    assert held >= arena + st
    ex.release()
    gc.collect()
    torch.cuda.synchronize()
    assert prog() is None and graph() is None
    assert torch.cuda.memory_allocated() - base < 4096


@pytest.mark.cuda
def test_fused_serving_stream_matches_reference():
    """SearchClient(supersteps_per_dispatch=4) on the card: the short
    stream's results equal the numpy oracle's, through fused dispatches
    that commit-escaped, some on session sub-arenas."""
    need_cuda()
    from repro_torch.core import fused

    n_cap = fused.captures
    got, stats, _ = serving_stream("cuda", K=4)
    want, _, _ = serving_stream("reference", K=4)
    assert stats.fused_dispatches > 0 and stats.fused_escape_commit > 0
    assert stats.fused_compacted_supersteps > 0
    assert fused.captures > n_cap
    for uid, b in want.items():
        a = got[uid]
        assert (a.actions, a.rewards, a.supersteps, a.cancelled,
                a.deadline_evicted) == (b.actions, b.rewards, b.supersteps,
                                        b.cancelled, b.deadline_evicted), uid
        for k in (b.tree_snapshot or {}):
            np.testing.assert_array_equal(a.tree_snapshot[k],
                                          b.tree_snapshot[k], err_msg=k)


@pytest.mark.cuda
def test_select_kernel_captures_past_48k_shared_memory():
    """uct_select.cu raises its dynamic shared-memory attribute per call
    above 48 KB (p > 2457).  That call is legal while a CUDA graph is
    being captured: a captured launch at p=2600 equals the eager one."""
    need_cuda()
    cfg = SWEEP[1]
    arrays = grown_arena(cfg, 1, 4, np.random.RandomState(0))
    p = 2600
    act = torch.ones(1, dtype=torch.int32, device="cuda")
    a, b = from_numpy(arrays, "cuda"), from_numpy(arrays, "cuda")
    want = uct_select.select_arena(cfg, a, act, p)
    n = uct_select.launches
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        got = uct_select.select_arena(cfg, b, act, p)
    uct_select.launches = n
    g.replay()
    torch.cuda.synchronize()
    for k in intree.SEL_FIELDS:
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    for k in ("edge_VL", "node_O"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k


# -- pipelined gangs and sharded pools (service.pool) on the card ---------

def assert_streams_equal(got, want):
    for uid, b in want.items():
        a = got[uid]
        assert (a.actions, a.rewards, a.supersteps, a.cancelled,
                a.deadline_evicted) == (b.actions, b.rewards, b.supersteps,
                                        b.cancelled, b.deadline_evicted), uid
        for va, vb in zip(a.visit_counts, b.visit_counts):
            np.testing.assert_array_equal(va, vb)
        for k in (b.tree_snapshot or {}):
            np.testing.assert_array_equal(a.tree_snapshot[k],
                                          b.tree_snapshot[k], err_msg=k)


@pytest.mark.cuda
def test_two_gang_graphs_in_flight_match_eager_body():
    """Two gangs' fused dispatches on one arena, each replaying its own
    captured CUDA graph, both submitted before either is collected,
    equal the plain (faithful) eager body run gang after gang from the
    same arena, bit for bit."""
    need_cuda()
    from repro_torch.core import fused
    from repro_torch.core.executor import CudaExecutor

    cfg, _, _, _ = FUSED_CASES["ran_k"]
    arrays, states, env, sim = fused_start(cfg, False)
    gangs = [np.array([True, False, True, False]),
             np.array([False, True, False, True])]
    budgets = np.array([3, 100, 100, 5], np.int32)
    ex = CudaExecutor(cfg, 4, device="cuda", _trees=from_numpy(arrays, "cuda"))
    pend = [ex.run_supersteps_submit(m, 4, 8, env, sim, states, budgets,
                                     False, gang=i)
            for i, m in enumerate(gangs)]
    assert ex._fused[0]._in_flight and ex._fused[1]._in_flight
    assert ex._fused[0].graph is not None and ex._fused[1].graph is not None
    got = [ex.run_supersteps_collect(x) for x in pend]
    plain = fused.FusedProgram(cfg, "faithful", from_numpy(arrays, "cuda"), 4,
                               env, sim, False)
    want = [plain.collect(plain.submit(m, 8, states, budgets)) for m in gangs]
    for d, w, m in zip(got, want, gangs):
        assert (d.n, d.escape) == (w.n, w.escape)
        for k in ("size_pre", "sizes", "states_lo"):
            np.testing.assert_array_equal(getattr(d, k), getattr(w, k))
        for r in np.flatnonzero(m):
            np.testing.assert_array_equal(d.written(r)[1], w.written(r)[1])
    a, b = to_numpy(ex.trees), to_numpy(plain.trees)
    for k in TREE_FIELDS:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.cuda
def test_overlap_stage_makes_no_host_sync(monkeypatch):
    """The overlap mode's staged device half (Selection + Node Insertion
    of a gang) queues its work without a host sync: every _stage of a
    stream runs under CUDA's sync debug mode "error", and the stream's
    results equal the numpy oracle's with the same overlap settings."""
    need_cuda()
    from repro_torch.service.pool import ArenaPool

    stage = ArenaPool._stage
    staged = []

    def strict(pool, gang, active):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = stage(pool, gang, active)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        staged.append(pool._inflight is not None)
        return out

    monkeypatch.setattr(ArenaPool, "_stage", strict)
    got, stats, _ = serving_stream("cuda", overlap=True, compact_threshold=0.0)
    monkeypatch.undo()
    assert any(staged)          # a gang staged while another was in flight
    want, _, _ = serving_stream("reference", overlap=True,
                                compact_threshold=0.0)
    assert_streams_equal(got, want)


@pytest.mark.cuda
def test_sharded_pool_on_one_card_matches_reference():
    """n_shards=2 with both shards on cuda:0: the short stream, masked
    and on per-shard session sub-arenas, equals the numpy oracle's, and
    each phase launches each tree kernel once per shard with an active
    slot."""
    need_cuda()
    from repro_torch.launch.mesh import serving_devices

    assert serving_devices(2, "cuda:0")[0] == torch.device("cuda", 0)
    n_sel = uct_select.launches
    got, stats, _ = serving_stream("cuda", n_shards=2,
                                   shard_devices=[torch.device("cuda", 0)] * 2)
    assert stats.session_gathers >= 1
    assert stats.supersteps <= uct_select.launches - n_sel <= 2 * stats.supersteps
    want, _, _ = serving_stream("reference", n_shards=2)
    assert_streams_equal(got, want)


# -- the Gomoku benchmark: the policy-value net as the Simulation backend --

def gomoku_states(n, seed):
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


def nn_params(channels=32):
    from repro_torch.envs.policy_net import init_params

    return init_params(torch.Generator().manual_seed(0), channels=channels)


@pytest.mark.cuda
def test_policy_net_on_card_matches_cpu():
    """The net on the card (TF32 off) within 1e-5 of the same net on the
    CPU; the backend's rows bit-identical across batch sizes on the card,
    terminal values exact."""
    need_cuda()
    from repro_torch.envs import GomokuEnv
    from repro_torch.envs.policy_net import (
        NNSimBackend, PolicyValueNet, canonical_boards, exact_f32,
    )

    params = nn_params()
    states = gomoku_states(256, 0)
    boards = torch.from_numpy(canonical_boards(states)).view(-1, 6, 6)
    with exact_f32(), torch.no_grad():
        cv, cl = PolicyValueNet(params)(boards)
        gv, gl = PolicyValueNet(params).cuda()(boards.cuda())
    assert (gv.cpu() - cv).abs().max() <= 1e-5
    assert (gl.cpu() - cl).abs().max() <= 1e-5
    be = NNSimBackend(GomokuEnv(), params)
    v, pr = be.evaluate(states)
    cpu_v, cpu_p = NNSimBackend(GomokuEnv(), params, device="cpu").evaluate(states)
    term = states[:, 1] != 0
    np.testing.assert_array_equal(v[term], cpu_v[term])
    np.testing.assert_allclose(v, cpu_v, rtol=0, atol=1e-5)
    np.testing.assert_allclose(pr, cpu_p, rtol=0, atol=1e-5)
    for B in (1, 16, 64):
        bv, bp = be.evaluate(states[:B])
        np.testing.assert_array_equal(bv, v[:B])
        np.testing.assert_array_equal(bp, pr[:B])


@pytest.mark.cuda
def test_nn_dispatch_makes_no_host_sync():
    """NNSimBackend.dispatch (pinned staging, non-blocking upload, the
    forward and the download queued, an event recorded) runs under CUDA's
    sync debug mode "error"; finalize waits on the event."""
    need_cuda()
    from repro_torch.envs import GomokuEnv
    from repro_torch.envs.policy_net import NNSimBackend

    be = NNSimBackend(GomokuEnv(), nn_params())
    states = gomoku_states(16, 1)
    want = be.evaluate(states)          # warm: the staging exists
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tok = be.dispatch(states)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = be.finalize(tok, states)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_nn_dispatches_in_flight_keep_their_rows():
    """Two dispatches in flight at once, finalized in the other order,
    each return their own rows (each owns its pinned staging)."""
    need_cuda()
    from repro_torch.envs import GomokuEnv
    from repro_torch.envs.policy_net import NNSimBackend

    be = NNSimBackend(GomokuEnv(), nn_params())
    a, b = gomoku_states(16, 2), gomoku_states(100, 3)
    want_a, want_b = be.evaluate(a), be.evaluate(b)
    ta, tb = be.dispatch(a), be.dispatch(b)
    for got, want in ((be.finalize(tb, b), want_b), (be.finalize(ta, a), want_a)):
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)


@pytest.mark.cuda
def test_gomoku_mcts_cuda_matches_reference():
    """TreeParallelMCTS at the Gomoku width (X=48,000, F=36, D=5, p=16,
    expand-all, PUCT) with the net on the card: the cuda executor's
    selections and tree equal the numpy oracle's over 12 supersteps,
    one launch of each tree kernel a superstep."""
    need_cuda()
    from repro_torch.configs.gomoku_cfg import TREE
    from repro_torch.core import TreeParallelMCTS
    from repro_torch.envs import GomokuEnv
    from repro_torch.envs.policy_net import NNSimBackend

    sim = NNSimBackend(GomokuEnv(), nn_params())
    mc, mr = (TreeParallelMCTS(TREE, GomokuEnv(), sim, p=16, executor=ex,
                               alternating_signs=True, expansion="vector")
              for ex in ("cuda", "reference"))
    n_sel, n_bak = uct_select.launches, uct_backup.launches
    for step in range(12):
        a, b = mc.superstep(), mr.superstep()
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{step}: {k}")
    assert uct_select.launches - n_sel == 12 == uct_backup.launches - n_bak
    sa, sb = mc.exec.snapshot(mc.tree), mr.exec.snapshot(mr.tree)
    for k in sb:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)
    assert sa["edge_P"].any()


@pytest.mark.cuda
def test_gomoku_serving_with_simserver_matches_reference():
    """A short Gomoku stream through SearchClient with SimServer and the
    cache (the net on the card): the cuda client equals the numpy-oracle
    client with the same sim stack, cache off equals cache on, the cache
    hits, and every forward has max_batch rows."""
    need_cuda()
    from repro_torch.envs import GomokuEnv
    from repro_torch.envs.policy_net import NNSimBackend
    from repro_torch.obs import MetricsRegistry
    from repro_torch.service import SearchClient, SearchRequest
    from repro_torch.sim import CachedSimBackend, SimServer

    cfg = TreeConfig(X=2048, F=36, D=5, beta=5.0, score_fn="puct",
                     leaf_mode="unexpanded", expand_all=True)
    params = nn_params(8)

    def run(executor, cache):
        nn = NNSimBackend(GomokuEnv(), params)
        rows = []
        dispatch = nn.dispatch
        nn.dispatch = lambda s: (rows.append(len(s)), dispatch(s))[1]
        sim = SimServer(nn, max_batch=32)
        reg = MetricsRegistry()
        if cache:
            sim = CachedSimBackend(sim, capacity=1024)
        cl = SearchClient(GomokuEnv(), sim_backend=sim, G=4, p=8,
                          executor=executor, default_cfg=cfg,
                          alternating_signs=True, expansion="vector",
                          metrics=reg)
        try:
            hs = [cl.submit(SearchRequest(uid=i, seed=i, budget=4 + i % 3,
                                          moves=1 + i % 2, keep_tree=True))
                  for i in range(6)]
            return {h.uid: h.result() for h in hs}, reg, rows
        finally:
            cl.close()

    got, reg, rows = run("cuda", True)
    want, _, _ = run("reference", True)
    off, _, rows_off = run("cuda", False)
    assert_streams_equal(got, want)
    assert_streams_equal(off, got)
    assert reg.get("sim_cache_hits_total").value > 0
    assert set(rows) == set(rows_off) == {32}


# ------------------------------------------------- the recurrent LM families

def mixer_on(kind, cfg, params, u, cache, device):
    from repro_torch.models import rglru, ssd

    fwd = ssd.ssd_forward if kind == "ssd" else rglru.rglru_forward
    mv = lambda t: t.to(device)
    p = {k: ({kk: mv(vv) for kk, vv in v.items()} if isinstance(v, dict)
             else mv(v)) for k, v in params.items()}
    c = None if cache is None else {k: mv(v).clone() for k, v in cache.items()}
    y, c = fwd(cfg, p, mv(u), c)
    return y.cpu(), None if c is None else {k: v.cpu() for k, v in c.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("width", ["smoke", "full"])
@pytest.mark.parametrize("kind", ["ssd", "rglru"])
def test_recurrent_mixer_on_card_matches_cpu(kind, width):
    """One SSD (mamba2-2.7b) or RG-LRU (recurrentgemma-9b) layer, SMOKE
    or full width, f32 with TF32 off: the chunked prefill (300 tokens:
    over a chunk boundary at both widths' scan chunks) and a decode step
    from its cache, on the card within 1e-4 of the CPU."""
    need_cuda()
    import dataclasses

    from repro_torch import configs
    from repro_torch.envs.policy_net import exact_f32
    from repro_torch.models import rglru, ssd

    arch = "mamba2-2.7b" if kind == "ssd" else "recurrentgemma-9b"
    cfg = dataclasses.replace(configs.get_config(arch, smoke=width == "smoke"),
                              dtype="float32")
    if width == "full":
        cfg = dataclasses.replace(cfg, ssd_chunk=256)
    gen = torch.Generator().manual_seed(0)
    params = (ssd.init_ssd if kind == "ssd" else rglru.init_rglru)(cfg, gen)
    init_cache = ssd.init_ssd_cache if kind == "ssd" else rglru.init_rglru_cache
    rng = np.random.RandomState(1)
    u = torch.tensor(rng.randn(2, 300, cfg.d_model), dtype=torch.float32)
    u1 = torch.tensor(rng.randn(2, 1, cfg.d_model), dtype=torch.float32)
    with exact_f32():
        for inp, cache in ((u, None), (u, init_cache(cfg, 2, "cpu"))):
            cy, cc = mixer_on(kind, cfg, params, inp, cache, "cpu")
            gy, gc = mixer_on(kind, cfg, params, inp, cache, "cuda")
            torch.testing.assert_close(gy, cy, atol=1e-4, rtol=1e-4)
        cy, _ = mixer_on(kind, cfg, params, u1, cc, "cpu")
        gy, _ = mixer_on(kind, cfg, params, u1, cc, "cuda")
        torch.testing.assert_close(gy, cy, atol=1e-4, rtol=1e-4)
        for k in cc:
            torch.testing.assert_close(gc[k].float(), cc[k].float(),
                                       atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "recurrentgemma-9b"])
def test_reused_slot_on_card_equals_fresh_batcher(arch):
    """Five requests through a pool of 2 on the card (SMOKE, f32, TF32
    off): each request's log-probs within 1e-4 of a fresh batcher that
    serves it alone.  Rows may change with the batch's other rows on the
    card, so the tokens are compared through their log-probs within a
    tolerance; a stale recurrent state moves them by far more."""
    need_cuda()
    from repro_torch import configs
    from repro_torch.envs.policy_net import exact_f32
    from repro_torch.models import lm
    from repro_torch.serving import ContinuousBatcher, Request

    cfg = configs.get_config(arch, smoke=True)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    rng = np.random.RandomState(9)
    prompts = [rng.randint(1, cfg.vocab, size=2 + 3 * i % 7).astype(np.int32)
               for i in range(5)]

    def serve(batch):
        b = ContinuousBatcher(cfg, params, pool_size=2, max_seq=48,
                              impl="flash", record_logprobs=True)
        for i, p in batch:
            b.submit(Request(uid=i, prompt=p, max_new_tokens=5))
        return {r.uid: r for r in b.run(max_steps=200)}

    with exact_f32():
        pooled = serve(list(enumerate(prompts)))
        for i, p in enumerate(prompts):
            alone = serve([(i, p)])[i]
            np.testing.assert_allclose(pooled[i].logprobs, alone.logprobs,
                                       atol=1e-4, rtol=1e-4, err_msg=str(i))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "deepseek-v3-671b"])
@pytest.mark.parametrize("ties", [False, True])
def test_moe_dispatch_on_card_matches_cpu(arch, ties):
    """The published E and K at T=4,096 tokens: the dispatch of one set of
    router probabilities on the card and on the CPU, every integer
    identical (ties: the router's columns duplicated in pairs), gates
    within 1e-7."""
    need_cuda()
    from repro_torch import configs
    from repro_torch.models import moe

    cfg = configs.get_config(arch)
    E, K = cfg.n_experts, cfg.top_k
    gen = torch.Generator(device="cuda").manual_seed(0)
    logits = torch.randn((4096, E), generator=gen, device="cuda")
    logits += torch.linspace(0, 2, E, device="cuda")     # some experts overflow
    if ties:
        logits = logits[:, 0::2].repeat_interleave(2, dim=1)
    probs = torch.softmax(logits, -1)
    got, want = moe.dispatch(probs, K), moe.dispatch(probs.cpu(), K)
    assert got.C == want.C and not bool(want.keep.all())
    for name in ("eidx", "order", "slot", "keep"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name
    torch.testing.assert_close(got.gate.cpu(), want.gate, atol=1e-7, rtol=0)


def _on(tree, device):
    if isinstance(tree, dict):
        return {k: _on(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_on(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "deepseek-v3-671b"])
def test_moe_layer_on_card_matches_cpu(arch):
    """One SMOKE MoE layer, f32 with TF32 off, 48 tokens at capacity
    factors 1.25 and 0.5 (pairs drop): y and aux on the card within 1e-5
    of the CPU."""
    need_cuda()
    from repro_torch import configs
    from repro_torch.envs.policy_net import exact_f32
    from repro_torch.models import moe

    cfg = configs.get_config(arch, smoke=True)
    p = moe.init_moe(cfg, torch.Generator().manual_seed(0))
    x = torch.tensor(np.random.RandomState(1).randn(2, 24, cfg.d_model),
                     dtype=torch.float32)
    with exact_f32():
        for cf in (1.25, 0.5):
            cy, ca = moe.moe_forward(cfg, p, x, cf)
            gy, ga = moe.moe_forward(cfg, _on(p, "cuda"), x.cuda(), cf)
            torch.testing.assert_close(gy.cpu(), cy, atol=1e-5, rtol=1e-5)
            torch.testing.assert_close(ga.cpu(), ca, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("absorb", [False, True])
def test_mla_on_card_matches_cpu(absorb):
    """One SMOKE MLA layer, f32 with TF32 off: the naive and blockwise
    prefill of 600 tokens (two query blocks) and, from a 13-token prefill
    into the latent cache, 3 decode steps (decompressed or absorbed): the
    outputs and the cache on the card within 1e-5 of the CPU."""
    need_cuda()
    import dataclasses

    from repro_torch import configs
    from repro_torch.envs.policy_net import exact_f32
    from repro_torch.models import attention as A

    cfg = dataclasses.replace(configs.get_config("deepseek-v3-671b", smoke=True),
                              mla_absorb=absorb)
    spec = cfg.groups[0][0][0]
    p = A.init_attn(cfg, torch.Generator().manual_seed(0), spec)
    rng = np.random.RandomState(2)
    x = torch.tensor(rng.randn(2, 600, cfg.d_model), dtype=torch.float32)
    pos = torch.arange(600)
    with exact_f32():
        for impl in ("naive", "blockwise"):
            c, _ = A.attn_forward(cfg, spec, p, x, pos, None, impl)
            g, _ = A.attn_forward(cfg, spec, _on(p, "cuda"), x.cuda(), pos.cuda(),
                                  None, impl)
            torch.testing.assert_close(g.cpu(), c, atol=1e-5, rtol=1e-5)
        caches = {d: A.init_cache(cfg, spec, 2, 24, d) for d in ("cpu", "cuda")}
        for step, S in enumerate((13, 1, 1, 1)):
            xs = torch.tensor(rng.randn(2, S, cfg.d_model), dtype=torch.float32)
            ps = torch.arange(S) + (0 if step == 0 else 12 + step)
            c, _ = A.attn_forward(cfg, spec, p, xs, ps, caches["cpu"], "blockwise")
            g, _ = A.attn_forward(cfg, spec, _on(p, "cuda"), xs.cuda(), ps.cuda(),
                                  caches["cuda"], "blockwise")
            torch.testing.assert_close(g.cpu(), c, atol=1e-5, rtol=1e-5)
            torch.testing.assert_close(caches["cuda"]["c"].cpu(),
                                       caches["cpu"]["c"], atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "deepseek-v3-671b"])
def test_moe_model_on_card_matches_cpu(arch):
    """The whole SMOKE model, f32 with TF32 off: logits and aux of a
    40-token forward (mixtral's prefill through the flash kernel, one
    launch a layer) on the card within 1e-4 of the CPU."""
    need_cuda()
    from repro_torch import configs
    from repro_torch.envs.policy_net import exact_f32
    from repro_torch.models import lm

    cfg = configs.get_config(arch, smoke=True)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tok = torch.tensor(np.random.RandomState(3).randint(0, cfg.vocab, (2, 40)))
    with exact_f32():
        cl, _, ca = lm.forward(cfg, params, tok, impl="flash")
        n = FA.launches
        gl, _, ga = lm.forward(cfg, _on(params, "cuda"), tok.cuda(), impl="flash")
        torch.cuda.synchronize()
    assert FA.launches - n == (cfg.n_layers if cfg.attn_impl == "gqa" else 0)
    torch.testing.assert_close(gl.cpu(), cl, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(ga.cpu(), ca, atol=1e-5, rtol=1e-5)


def _granite_bf16_rows():
    """granite-4.0-h-small's SMOKE shape in bf16 on the card: its params,
    two prefixes (13 and 21 tokens, B=1 caches of 48) and 16 suffixes of
    4 tokens."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import lm, steps
    from repro_torch.serving import batcher as B

    cfg = dataclasses.replace(configs.get_config("granite-4.0-h-small",
                                                 smoke=True), dtype="bfloat16")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    rng = np.random.default_rng(4)
    pre = []
    for n in (13, 21):
        toks = rng.integers(0, cfg.vocab, n)
        caches = lm.init_caches(cfg, 1, 48, "cuda")
        logits = steps.make_prefill_step(cfg, "naive")(
            params, torch.as_tensor(toks, device="cuda")[None], caches)[0]
        pre.append(B.PrefixState(toks, caches,
                                 logits[0].float().cpu().numpy()))
    return cfg, params, pre, rng.integers(0, cfg.vocab, (16, 4))


def _leaves(caches, rows, upto=None):
    """Rows `rows` of every cache leaf (of k/v the first `upto`
    positions: what the rows hold), cloned."""
    return [(t[:, rows, :upto] if name in ("k", "v") else t[:, rows]).clone()
            for per_pos in caches.values() for c in per_pos
            for name, t in c.items() if name != "pos"]


@pytest.mark.cuda
def test_batched_admission_graphs_on_card():
    """The pool's B-row extend (granite's SMOKE shape, bf16, 16 rows from
    two prefixes): each graph replay equals the eager B-row extend bit for
    bit (logits and scratch); a group of 5 padded with 11 dummies gives
    its rows' logits and caches of the full group of 16 bit for bit; and
    a batcher admitting 5 rows through the padded graph leaves its 11
    other slots as they were."""
    need_cuda()
    from repro_torch.serving import batcher as B

    cfg, params, pre, suffixes = _granite_bf16_rows()
    counters = B.LMCounters("cuda")
    graphed = B.Extender(cfg, params, 48, "naive", counters, 4, rows=16)
    eager = B.Extender(cfg, params, 48, "naive", counters, rows=16)
    assert sorted(graphed.graphs) == [1, 2, 3, 4]
    for S in (1, 2, 3, 4):
        runs = [(pre[0].caches, 13, suffixes[:8, :S]),
                (pre[1].caches, 21, suffixes[8:, :S])]
        full = graphed.run_rows(runs).clone()
        assert torch.equal(full, eager.run_rows(runs)), S
        for rows, n in ((list(range(8)), 13), (list(range(8, 16)), 21)):
            for a, b in zip(_leaves(graphed.scratch, rows, n + S),
                            _leaves(eager.scratch, rows, n + S)):
                assert torch.equal(a, b), S
        kept = [_leaves(graphed.scratch, [0, 1, 2], 13 + S),
                _leaves(graphed.scratch, [8, 9], 21 + S)]
        part = graphed.run_rows([(pre[0].caches, 13, suffixes[:3, :S]),
                                 (pre[1].caches, 21, suffixes[8:10, :S])])
        assert torch.equal(part, full[[0, 1, 2, 8, 9]]), S
        for rows, n, want in (([0, 1, 2], 13, kept[0]), ([3, 4], 21, kept[1])):
            for a, b in zip(_leaves(graphed.scratch, rows, n + S), want):
                assert torch.equal(a, b), S
    b = B.ContinuousBatcher(
        cfg, params, pool_size=16, max_seq=48, impl="naive",
        extender=B.Extender(cfg, params, 48, "naive", B.LMCounters("cuda"),
                            4), cuda_graphs=True)
    assert sorted(b.group_extender.graphs) == [1, 2, 3, 4]
    gen = torch.Generator(device="cuda").manual_seed(5)
    for per_pos in b.caches.values():
        for c in per_pos:
            for name, t in c.items():
                if name != "pos":
                    t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))
    free = [2, 5, 6, 11, 12]
    others = [s for s in range(16) if s not in free]
    for slot in others:
        b.slots[slot] = B.Request(uid=-1, prompt=np.zeros(5, np.int32))
    before = _leaves(b.caches, others)
    for i, slot in enumerate(free):
        p = pre[i % 2]
        b.submit(B.Request(uid=i, prompt=np.concatenate(
            [p.tokens, suffixes[i, :2]]).astype(np.int32), prefix=p))
    b._admit()
    assert [b.slots[s].uid for s in free] == [0, 1, 2, 3, 4]
    for x, y in zip(_leaves(b.caches, others), before):
        assert torch.equal(x, y)
    # the admitted rows hold what a B-row graph of these five gives
    want = graphed.run_rows([(pre[0].caches, 13, suffixes[[0, 2, 4], :2]),
                             (pre[1].caches, 21, suffixes[[1, 3], :2])])
    assert [b.slots[s].tokens[0] for s in (2, 6, 12, 5, 11)] == \
        torch.argmax(want, -1).tolist()
    for rows, n, mine in (([2, 6, 12], 13, [0, 1, 2]), ([5, 11], 21, [3, 4])):
        for x, y in zip(_leaves(b.caches, rows, n + 2),
                        _leaves(graphed.scratch, mine, n + 2)):
            assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-small", "paligemma-3b"])
def test_encdec_prefill_decode_on_card_matches_cpu(arch):
    """The SMOKE model, f32 with TF32 off, by serve's route: a 16-token
    prefill with seeded frames (whisper: the flash kernel in every
    encoder layer, decoder self-attention and cross-attention) or
    patches (paligemma: blockwise, no launch), then 4 teacher-forced
    decode steps at serve's cache size; every row on the card within
    1e-4 of the CPU."""
    need_cuda()
    from repro_torch import configs
    from repro_torch.envs.policy_net import exact_f32
    from repro_torch.launch import serve
    from repro_torch.models import lm, steps

    cfg = configs.get_config(arch, smoke=True)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.RandomState(4)
    seq = torch.tensor(rng.randint(0, cfg.vocab, (2, 20)))
    extra = {}
    if cfg.encoder is not None:
        extra["frames"] = torch.tensor(
            rng.randn(2, cfg.encoder.n_frames, cfg.d_model), dtype=torch.float32)
    if cfg.vlm_patches:
        extra["patches"] = torch.tensor(
            rng.randn(2, cfg.vlm_patches, cfg.d_model), dtype=torch.float32)
    impl = serve.prefill_impl(cfg)

    def rows(dev):
        p = _on(params, dev)
        caches = lm.init_caches(cfg, 2, serve.cache_len(cfg, 16, 4), dev)
        lg, caches = steps.make_prefill_step(cfg, impl=impl)(
            p, seq[:, :16].to(dev), caches, **_on(extra, dev))
        out = [lg]
        dec = steps.make_decode_step(cfg, impl=impl)
        for i in range(16, 20):
            lg, caches = dec(p, caches, seq[:, i:i + 1].to(dev),
                             torch.tensor(i, device=dev))
            out.append(lg)
        return torch.stack(out, 1)

    with exact_f32():
        want = rows("cpu")
        n = FA.launches
        got = rows("cuda")
        torch.cuda.synchronize()
    enc = cfg.encoder.n_layers + 2 * cfg.n_layers if cfg.encoder else 0
    assert FA.launches - n == enc
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma3-12b", "mamba2-2.7b",
                                  "recurrentgemma-9b", "mixtral-8x22b",
                                  "deepseek-v3-671b", "whisper-small",
                                  "paligemma-3b"])
def test_train_steps_on_card_match_cpu(arch):
    """Three train steps of the SMOKE model (blockwise attention, AdamW
    at lr 1e-3 after one warmup step), f32 with TF32 off, from one CPU
    init and the same batches: loss, nll and grad_norm on the card within
    1e-4 (relative) of the CPU's at every step; no kernel launches."""
    need_cuda()
    from repro_torch import configs
    from repro_torch.data import SyntheticTokens
    from repro_torch.envs.policy_net import exact_f32
    from repro_torch.models import lm, steps
    from repro_torch.optim import make_optimizer

    cfg = configs.get_config(arch, smoke=True)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    init, update = make_optimizer("adamw", lr=1e-3, warmup=1)
    step = steps.make_train_step(cfg, update, impl="blockwise")
    src = SyntheticTokens(cfg.vocab, 2, 24, seed=2)
    rng = np.random.RandomState(5)
    extra = {}
    if cfg.encoder is not None:
        extra["frames"] = torch.tensor(
            rng.randn(2, cfg.encoder.n_frames, cfg.d_model) * 0.1,
            dtype=torch.float32)
    if cfg.vlm_patches:
        extra["patches"] = torch.tensor(
            rng.randn(2, cfg.vlm_patches, cfg.d_model) * 0.1,
            dtype=torch.float32)

    def run(dev):
        p = _on(params, dev)
        st, out = init(p), []
        for i in range(3):
            batch = {k: torch.as_tensor(v) for k, v in src.batch_at(i).items()}
            p, st, m = step(p, st, i, _on({**batch, **extra}, dev))
            out.append([float(m[k]) for k in ("loss", "nll", "grad_norm")])
        return np.array(out)

    with exact_f32():
        want = run("cpu")
        n = FA.launches
        got = run("cuda")
    assert FA.launches == n
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)


@pytest.mark.cuda
def test_flash_under_autograd_raises_on_card():
    """impl="flash" has no backward: under autograd attn_forward raises on
    the card before it launches; under no_grad it launches once."""
    need_cuda()
    from repro_torch import configs
    from repro_torch.models import attention as A
    from repro_torch.models import lm

    cfg = configs.get_config("llama3.2-1b", smoke=True)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    layer = {k: v.cuda().requires_grad_(True)
             for k, v in lm._at(params["g0"][0], 0)["mix"].items()}
    spec = cfg.layer_specs()[0]
    x = torch.randn(2, 16, cfg.d_model, device="cuda")
    pos = torch.arange(16, dtype=torch.int32, device="cuda")
    n = FA.launches
    with pytest.raises(ValueError, match="no backward"):
        A.attn_forward(cfg, spec, layer, x, pos, impl="flash")
    assert FA.launches == n
    with torch.no_grad():
        A.attn_forward(cfg, spec, layer, x, pos, impl="flash")
    torch.cuda.synchronize()
    assert FA.launches == n + 1


@pytest.mark.cuda
def test_straggler_masked_superstep_on_card():
    """The cuda leg of tests/test_mcts_system.py's
    test_straggler_masked_superstep: random workers miss the barrier every
    superstep (their backups recover virtual loss only); the card's tree
    equals the reference executor's bit for bit, stays quiescent (VL == 0,
    O == 0), and the dropped workers add no visits."""
    need_cuda()
    from repro_torch.core import RolloutBackend, TreeParallelMCTS

    env = BanditTreeEnv(fanout=4, terminal_depth=8)
    cfg = TreeConfig(X=128, F=4, D=5)

    def run(executor, device, faults=True):
        m = TreeParallelMCTS(cfg, env, RolloutBackend(env, max_steps=8, seed=7),
                             p=8, executor=executor, seed=3, device=device)
        rng = np.random.RandomState(99)
        for _ in range(5):
            m.superstep(fault_injector=(lambda p: rng.rand(p) > 0.3)
                        if faults else None)
        return m.exec.snapshot(m.tree)

    a, b = run("reference", "cpu"), run("cuda", "cuda")
    for k in a:
        if k != "log_table":
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert np.all(b["edge_VL"] == 0) and np.all(b["node_O"] == 0)
    assert b["node_N"][0] < run("cuda", "cuda", faults=False)["node_N"][0]


# ------------------------------------------- the launch tooling (phase 17)

@pytest.fixture
def nccl_world(tmp_path, monkeypatch):
    """A world of one on the card (NCCL through a FileStore) and its 1x1
    (data, model) DeviceMesh; the group is destroyed afterwards."""
    need_cuda()
    import torch.distributed as dist

    from repro_torch.launch.distributed_init import init_distributed
    from repro_torch.launch.mesh import make_host_mesh

    for k in ("REPRO_NUM_PROCESSES", "REPRO_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    info = init_distributed(store=dist.FileStore(str(tmp_path / "store"), 1))
    try:
        assert info["backend"] == "nccl"
        yield make_host_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_collectives_on_card_bit_exact(nccl_world, dtype):
    """all_reduce, all_gather and broadcast on a world of one on the card
    return the seeded tensor bit for bit; the recorder counts each one's
    result bytes."""
    import torch.distributed as dist

    from repro_torch.launch import collectives

    mesh = nccl_world
    assert mesh.device_type == "cuda" and tuple(mesh.shape) == (1, 1)
    x = torch.from_numpy(np.random.RandomState(0).randn(64, 96).astype(
        np.float32)).to(dtype).cuda()
    t = x.clone()
    with collectives.record() as rec:
        dist.all_reduce(t, group=mesh.get_group("model"))
        parts = [torch.empty_like(t)]
        dist.all_gather(parts, t, group=mesh.get_group("data"))
        dist.broadcast(t, src=0)
    torch.cuda.synchronize()
    assert torch.equal(t, x) and torch.equal(parts[0], x)
    n = x.numel() * x.element_size()
    assert (rec.bytes["all_reduce"], rec.bytes["all_gather"],
            rec.bytes["broadcast"], rec.bytes["total"]) == (n, n, n, 3 * n)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "deepseek-v3-671b"])
def test_moe_shard_map_on_card_identical_to_dense(nccl_world, arch):
    """The SMOKE MoE layer through the shard-map path on the card's 1x1
    mesh (the arch's train_4k rules of specs.OPTIMIZED_RULES): y and aux
    identical to the dense path's; the model all-reduce of y recorded."""
    from repro_torch import configs
    from repro_torch.launch import collectives, specs
    from repro_torch.models import moe, sharding as sh

    cfg = configs.get_config(arch, smoke=True)
    p = moe.init_moe(cfg, torch.Generator(device="cuda").manual_seed(0))
    x = torch.randn(4, 16, cfg.d_model, device="cuda")
    y0, aux0 = moe.moe_forward(cfg, p, x)
    sh.set_context(nccl_world, specs.OPTIMIZED_RULES[(arch, "train_4k")])
    try:
        with collectives.record() as rec:
            y1, aux1 = moe.moe_forward(cfg, p, x)
    finally:
        sh.set_context(None)
    assert torch.equal(y0, y1) and torch.equal(aux0, aux1)
    assert rec.bytes["all_reduce"] == y1.numel() * y1.element_size()


@pytest.mark.cuda
def test_restore_onto_card_mesh(nccl_world, tmp_path):
    """SMOKE llama3.2-1b's parameters saved and restored onto the card's
    mesh with make_param_shardings' tree: every leaf a DTensor on the
    mesh, equal to the saved leaf bit for bit."""
    from torch.distributed.tensor import DTensor

    from repro_torch import configs
    from repro_torch.distributed.checkpoint import (restore_checkpoint,
                                                    save_checkpoint)
    from repro_torch.models import lm, sharding as sh
    from repro_torch.pytree import tree_leaves

    cfg = configs.get_config("llama3.2-1b", smoke=True)
    params = lm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                            "cuda")
    save_checkpoint(tmp_path, 1, params)
    shd = sh.make_param_shardings(nccl_world, sh.Rules(), lm.param_axes(cfg),
                                  params)
    out, _ = restore_checkpoint(tmp_path, 1, params, shd)
    for a, b in zip(tree_leaves(params), tree_leaves(out)):
        assert isinstance(b, DTensor) and b.device_mesh is nccl_world
        assert b.to_local().is_cuda and torch.equal(b.to_local(), a)
