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
executor must free its arena (and its graph).
The flash-attention kernel is held to its plain version at the JAX flash
test's tolerances (f32 2e-5, bf16 2e-2); in bf16 also to the plain version
run in f32 on the same inputs, within one bf16 rounding of the output,
over every head dim, the LM paths' short rows, windows, non-causal
Sq != Sk and fused-projection views; a misaligned bf16 stride raises.
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
