"""The CUDA kernels against their plain torch versions, on the card.

Needs a CUDA device (and nvcc, which builds the kernels at first use);
elsewhere every test here skips with its reason.  Imports only torch,
numpy and repro_torch, so it runs where jax is not installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Trees are grown with the port's plain ops on the CPU from a numpy seed,
then copied to the card twice: one copy goes through the kernels, the
other through the plain versions, and every array must be identical.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import fixedpoint as fx
from repro_torch.core import intree
from repro_torch.core.tree import NULL, TreeConfig, from_numpy, init_arena, to_numpy
from repro_torch.kernels import uct_backup, uct_select

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
