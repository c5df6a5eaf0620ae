"""Port vs JAX package: the selection variants, the sync-free Node
Insertion and the executor protocol of the serving stack, bit for bit.

  * relaxed and wavefront Selection (repro_torch.core.intree) against
    repro.core.intree on trees grown with the JAX ops, for every
    TREE_SWEEP config x p in {1, 4, 16}, as single trees and as a G=4
    arena under random active masks (wavefront's stable within-group
    rank only shows at p >= 4 with colliding paths);
  * Node Insertion (no host sync: scatter-adds over the whole id block)
    against the JAX insert_arena under random active masks, G in {1, 4};
  * insert() == insert_host(insert_dev()) on every executor, insert_dev
    returning the id block on the device;
  * gather_sub -> scatter_sub round trips against masked execution, and
    CompactionSession reuse, sync and close.

Everything runs on the CPU; integers are compared with zero tolerance.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import intree as jintree
from repro.core.tree import stack_trees
from repro_torch.core import intree as tintree
from repro_torch.core.executor import (
    EXECUTOR_NAMES, CompactionSession, CudaExecutor, make_intree_executor,
)
from repro_torch.core.tree import NULL, TreeConfig as TCfg, from_numpy
from repro_torch.obs import Tracer
from test_kernels_uct import TREE_SWEEP, grow_tree
from test_torch_intree import (
    CFG_IDS, assert_sel_equal, assert_trees_equal, jax_arrays,
)

VARIANTS = ("relaxed", "wavefront")


def jax_arena(cfg, G):
    """G trees grown with the JAX ops to different sizes (deeper trees
    than test_torch_intree's, so that workers meet below the root)."""
    return stack_trees([grow_tree(cfg, supersteps=3 + 2 * g, p=4, seed=g)
                        for g in range(G)])


def random_mask(rng, G):
    active = rng.rand(G) < 0.6
    active[rng.randint(G)] = True
    return active


@pytest.mark.parametrize("cfg", TREE_SWEEP, ids=CFG_IDS)
@pytest.mark.parametrize("p", [1, 4, 16])
@pytest.mark.parametrize("variant", VARIANTS)
def test_selection_variant_matches_jax(cfg, p, variant):
    tcfg = TCfg(**dataclasses.asdict(cfg))
    jt = grow_tree(cfg, supersteps=5, p=4, seed=p)
    tt = from_numpy(jax_arrays(jt), "cpu")
    if variant == "wavefront":
        jt, jsel = jintree.select_batch_wavefront(cfg, jt, p)
    else:
        jt, jsel = jintree.select_batch(cfg, jt, p, True)
    tsel = tintree.select_batch(tcfg, tt, p, variant)
    assert_sel_equal(jsel, tsel)
    assert_trees_equal(jt, tt)


@pytest.mark.parametrize("cfg", TREE_SWEEP, ids=CFG_IDS)
@pytest.mark.parametrize("p", [1, 4, 16])
@pytest.mark.parametrize("variant", VARIANTS)
def test_selection_variant_arena_matches_jax(cfg, p, variant):
    G = 4
    rng = np.random.RandomState(p)
    tcfg = TCfg(**dataclasses.asdict(cfg))
    ja = jax_arena(cfg, G)
    ta = from_numpy(jax_arrays(ja), "cpu")
    for _ in range(2):
        active = random_mask(rng, G)
        rows = np.flatnonzero(active)
        ja, jsel = jintree.select_arena(cfg, ja, jnp.asarray(active), p,
                                        variant)
        tsel = tintree.select_arena(tcfg, ta, active, p, variant)
        assert_sel_equal(jsel, tsel, rows)
        assert_trees_equal(ja, ta)
        # inactive rows keep the port's fixed dead values
        off = np.flatnonzero(~active)
        assert (tsel.path_nodes.numpy()[off] == NULL).all()
        assert (tsel.depths.numpy()[off] == 0).all()


@pytest.mark.parametrize("cfg", TREE_SWEEP, ids=CFG_IDS)
@pytest.mark.parametrize("p", [1, 4, 16])
@pytest.mark.parametrize("G", [1, 4])
def test_insert_arena_matches_jax_under_random_masks(cfg, p, G):
    """The sync-free Node Insertion equals the JAX insert_arena (and so
    the earlier boolean-indexed version of the port, which matched it)
    on every active slot, and leaves inactive slots untouched."""
    rng = np.random.RandomState(10 * p + G)
    tcfg = TCfg(**dataclasses.asdict(cfg))
    ja = jax_arena(cfg, G)
    ta = from_numpy(jax_arrays(ja), "cpu")
    for _ in range(3):
        active = random_mask(rng, G)
        rows = np.flatnonzero(active)
        ja, jsel = jintree.select_arena(cfg, ja, jnp.asarray(active), p)
        tsel = tintree.select_arena(tcfg, ta, active, p)
        ja, jnew = jintree.insert_arena(cfg, ja, jnp.asarray(active), jsel)
        tnew = tintree.insert_arena(tcfg, ta, active, tsel)
        np.testing.assert_array_equal(tnew.numpy()[rows],
                                      np.asarray(jnew)[rows])
        assert (tnew.numpy()[~active] == NULL).all()
        assert_trees_equal(ja, ta)


def grown_executor(cfg, name, G, p, supersteps, seed):
    """An executor whose G slots were grown by `supersteps` masked
    supersteps with seeded values (every slot active in the first)."""
    ex = make_intree_executor(cfg, G, name, device="cpu")
    rng = np.random.RandomState(seed)
    for step in range(supersteps):
        active = np.ones(G, bool) if step == 0 else random_mask(rng, G)
        superstep(ex, cfg, active, p, values(rng, G, p))
    return ex


def values(rng, rows: int, p: int) -> np.ndarray:
    """Seeded Qm.16 backup values for `rows` executor rows."""
    return rng.randint(-65536, 65537, (rows, p)).astype(np.int32)


def placed(vals: np.ndarray, idx: np.ndarray, G: int) -> np.ndarray:
    """A sub-arena's first A rows of values at their slots of the arena."""
    out = np.zeros((G, vals.shape[1]), np.int32)
    out[idx] = vals[:len(idx)]
    return out


def superstep(ex, cfg, active, p, vals, split=False):
    """Select, insert, finalize and back up on `ex` with backup values
    `vals` [G, p].  Returns the inserted ids."""
    G = ex.G
    sel_dev = ex.selection(active, p)
    if split:
        dev = ex.insert_dev(active, sel_dev)
        new = ex.insert_host(dev)
    else:
        new = ex.insert(active, sel_dev)
    sel = ex.sel_to_host(sel_dev)
    K = p * cfg.Fp if cfg.expand_all else p
    nodes = np.full((G, K), NULL, np.int32)
    for g in range(G):
        ins = new[g].reshape(-1)
        ins = ins[ins != NULL][:K]
        nodes[g, :len(ins)] = ins
    na = np.where(nodes != NULL, cfg.F, 0).astype(np.int32)
    ex.finalize(nodes, na, np.zeros_like(nodes), np.full((G, p), NULL, np.int32),
                np.zeros((G, p, cfg.Fp), np.int32))
    sim = np.where(sel["expand_action"] >= 0, new[:, :, 0],
                   sel["leaves"]).astype(np.int32)
    ex.backup(active, sel_dev, sim, vals, False)
    return new


def snapshots(ex):
    return [ex.slot_snapshot(g) for g in range(ex.G)]


def assert_snapshots_equal(a, b, slots=None):
    for g in range(len(a)) if slots is None else slots:
        for k in b[g]:
            np.testing.assert_array_equal(a[g][k], b[g][k],
                                          err_msg=f"slot {g} {k}")


CFG = TCfg(X=128, F=4, D=5)


@pytest.mark.parametrize("name", EXECUTOR_NAMES)
def test_insert_split_equals_insert(name):
    """insert() == insert_host(insert_dev()) bit for bit; on a device
    executor insert_dev returns the id block as a tensor (no host read)."""
    p, G = 4, 3
    a = grown_executor(CFG, name, G, p, 3, seed=1)
    b = grown_executor(CFG, name, G, p, 3, seed=1)
    rng = np.random.RandomState(5)
    for step in range(3):
        active = np.array([True, step != 1, True])
        vals = values(rng, G, p)
        new_a = superstep(a, CFG, active, p, vals)
        new_b = superstep(b, CFG, active, p, vals, split=True)
        np.testing.assert_array_equal(new_a, new_b)
    assert_snapshots_equal(snapshots(a), snapshots(b))
    if name != "reference":
        sel = a.selection(np.ones(G, bool), p)
        assert isinstance(a.insert_dev(np.ones(G, bool), sel), torch.Tensor)


@pytest.mark.parametrize("name", EXECUTOR_NAMES)
@pytest.mark.parametrize("members", [[1], [0, 2], [1, 2, 4]],
                         ids=["A1", "A2", "A3"])
def test_gather_scatter_round_trip(name, members):
    """A superstep on a gathered sub-arena, scattered back, equals the
    same superstep on the full arena under the member mask; slots that
    are not members are untouched, and on a device executor the filler
    rows (copies of the first member) run masked off."""
    p, G = 4, 5
    idx = np.asarray(members)
    A, Gc = len(idx), 1 << (len(idx) - 1).bit_length()
    full = grown_executor(CFG, name, G, p, 2, seed=3)
    masked = grown_executor(CFG, name, G, p, 2, seed=3)
    before = snapshots(full)
    sub = full.gather_sub(idx, Gc)
    assert type(sub) is type(full) and sub.G == Gc
    if name != "reference":
        assert all(getattr(sub.trees, k).is_contiguous()
                   for k in ("child", "edge_N", "node_O", "log_table"))
    vals = values(np.random.RandomState(7), Gc, p)
    new = superstep(sub, CFG, np.arange(Gc) < A, p, vals)
    if name != "reference":   # the oracle's fillers share the member's tree
        for f in snapshots(sub)[A:]:
            assert_snapshots_equal([f], [before[idx[0]]])
    full.scatter_sub(sub, idx)
    mask = np.zeros(G, bool)
    mask[idx] = True
    m_new = superstep(masked, CFG, mask, p, placed(vals, idx, G))
    after = snapshots(full)
    assert_snapshots_equal(after, snapshots(masked))
    assert_snapshots_equal(after, before,
                           [g for g in range(G) if g not in members])
    np.testing.assert_array_equal(new[:A], m_new[idx])


def test_cuda_executor_spawns_cuda_sub_executors():
    """A session's sub-arena on the cuda executor runs the hand-written
    kernels' wrappers, not the torch ops."""
    ex = CudaExecutor(CFG, 4, device="cpu")
    ses = ex.open_session(np.array([0, 2]), 2)
    assert isinstance(ses.sub, CudaExecutor) and ses.sub.variant == "cuda"


@pytest.mark.parametrize("name", ["reference", "faithful", "cuda"])
def test_compaction_session_reuse_sync_close(name):
    """One gather serves every superstep of a stable active set; sync
    scatters only when dirty; close scatters once more at most and the
    session refuses further use.  Spans land on the tracer's track."""
    p, G = 4, 4
    ex = grown_executor(CFG, name, G, p, 2, seed=4)
    ref = grown_executor(CFG, name, G, p, 2, seed=4)
    tr = Tracer()
    tid = tr.track("pool")
    idx = np.array([1, 3])
    ses = ex.open_session(idx, 2, tracer=tr, tid=tid)
    assert isinstance(ses, CompactionSession)
    assert ses.matches(idx, 2) and not ses.matches(np.array([1]), 2)
    assert ses.owns(3) and not ses.owns(0)
    assert ses.sync() is False                 # nothing to write back yet
    rng = np.random.RandomState(9)
    mask = np.zeros(G, bool)
    mask[idx] = True

    def step():
        ses.mark_superstep()
        vals = values(rng, 2, p)
        superstep(ses.sub, CFG, np.ones(2, bool), p, vals)
        superstep(ref, CFG, mask, p, placed(vals, idx, G))

    for _ in range(3):
        step()
    assert ses.supersteps == 3 and ses.dirty
    assert ses.sync() is True and not ses.dirty
    assert_snapshots_equal(snapshots(ex), snapshots(ref))
    step()
    assert ses.close() is True and not ses.open
    assert ses.close() is False
    assert_snapshots_equal(snapshots(ex), snapshots(ref))
    with pytest.raises(AssertionError, match="closed"):
        ses.mark_superstep()
    names = [e["name"] for e in tr.export()["traceEvents"]]
    assert names.count("compact-gather") == 1
    assert names.count("compact-scatter") == 2
