"""The CUDA kernels against their plain torch versions, on the card.

Needs a CUDA device (and nvcc, which builds the kernels at first use);
elsewhere every test here skips with its reason.  Imports only torch,
numpy and repro_torch, so it runs where jax is not installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Trees are grown with the port's plain ops on the CPU from a numpy seed,
then copied to the card twice: one copy goes through the kernels, the
other through the plain versions, and every array must be identical;
the Selection kernel also on its hazard cases (tests/tree_cases.py).
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
