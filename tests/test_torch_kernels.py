"""The port's kernel wrappers (kernels/uct_select.py, kernels/uct_backup.py).

On CPU tensors the wrappers run their plain versions; here they are held
bit for bit against the JAX package's Pallas kernels in interpret mode
(repro.kernels.ops) on a few small cases, and against repro.core.intree
on the full TREE_SWEEP x p sweep and the Selection kernel's hazard
cases (tests/tree_cases.py).  The wrappers must refuse a wrong
dtype, shape, device or layout.  The CUDA kernels themselves are held
against the plain versions by tests/test_torch_cuda.py, which needs a card
(and by chip_smoke.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fixedpoint as jfx
from repro.core import intree as jintree
from repro.core import tree as jtree
from repro.kernels import ops as jkops
from repro_torch.core import intree as tintree
from repro_torch.core.tree import (
    TreeConfig as TCfg, as_arena, from_numpy, init_arena, to_numpy,
)
from repro_torch.kernels import build, uct_backup, uct_select
from repro_torch.kernels import ops as tkops
from test_kernels_uct import TREE_SWEEP, grow_tree
import tree_cases

CFG_IDS = lambda c: f"F{c.F}-D{c.D}-{c.vl_mode}-{c.score_fn}"
FIELDS = ("edge_N", "edge_W", "edge_VL", "node_N", "node_O")


def jax_arrays(tree) -> dict:
    return {f.name: np.array(getattr(tree, f.name))
            for f in dataclasses.fields(tree)}


def port_arena(jtree):
    return as_arena(from_numpy(jax_arrays(jtree), "cpu"))


def one():
    return torch.ones(1, dtype=torch.int32)


@pytest.mark.parametrize("cfg", TREE_SWEEP[:3], ids=CFG_IDS)
def test_wrappers_match_pallas_interpret(cfg):
    from jax.experimental import pallas as pl
    if not hasattr(pl, "load"):
        pytest.skip("the JAX package's Pallas kernels call pl.load, which this "
                    "jax no longer has (ROADMAP.md queue C)")
    p = 6
    rng = np.random.RandomState(3)
    tcfg = TCfg(**dataclasses.asdict(cfg))
    jt = grow_tree(cfg, supersteps=2, p=4)
    ta = port_arena(jt)

    jt, jsel = jkops.select_batch(cfg, jt, p)
    tsel = tkops.select_arena(tcfg, ta, np.ones(1, np.int32), p)
    for k in tintree.SEL_FIELDS:
        np.testing.assert_array_equal(getattr(tsel, k).numpy()[0],
                                      np.asarray(getattr(jsel, k)), err_msg=k)
    np.testing.assert_array_equal(ta.edge_VL.numpy()[0], np.asarray(jt.edge_VL))
    np.testing.assert_array_equal(ta.node_O.numpy()[0], np.asarray(jt.node_O))

    jt, jnew = jintree.insert_batch(cfg, jt, jsel)
    tintree.insert_arena(tcfg, ta, np.ones(1, bool), tsel)
    sim = np.where(np.asarray(jsel.expand_action) >= 0, np.asarray(jnew)[:, 0],
                   np.asarray(jsel.leaves)).astype(np.int32)
    vals = np.asarray(jfx.encode(rng.uniform(-1, 1, p).astype(np.float32)))
    for alternating in (False, True):
        jb = jkops.backup_batch(cfg, jt, jsel, jnp.asarray(sim),
                                jnp.asarray(vals), alternating)
        tb = from_numpy(to_numpy(ta), "cpu")
        tkops.backup_arena(tcfg, tb, np.ones(1, np.int32), tsel, sim[None],
                           vals[None], alternating)
        for k in FIELDS:
            np.testing.assert_array_equal(getattr(tb, k).numpy()[0],
                                          np.asarray(getattr(jb, k)), err_msg=k)


@pytest.mark.parametrize("cfg", TREE_SWEEP, ids=CFG_IDS)
@pytest.mark.parametrize("p", [1, 4, 16])
def test_wrappers_match_jax_intree(cfg, p):
    rng = np.random.RandomState(p + 11)
    tcfg = TCfg(**dataclasses.asdict(cfg))
    jt = grow_tree(cfg, supersteps=2, p=4)
    ta = port_arena(jt)
    act = one()
    jt, jsel = jintree.select_batch(cfg, jt, p)
    tsel = uct_select.select_arena(tcfg, ta, act, p)
    for k in tintree.SEL_FIELDS:
        np.testing.assert_array_equal(getattr(tsel, k).numpy()[0],
                                      np.asarray(getattr(jsel, k)), err_msg=k)
    jt, jnew = jintree.insert_batch(cfg, jt, jsel)
    tintree.insert_arena(tcfg, ta, act, tsel)
    sim = np.where(np.asarray(jsel.expand_action) >= 0, np.asarray(jnew)[:, 0],
                   np.asarray(jsel.leaves)).astype(np.int32)
    vals = np.asarray(jfx.encode(rng.uniform(-1, 1, p).astype(np.float32)))
    drop = rng.rand(p) < 0.4
    jb = jintree.backup_batch(cfg, jt, jsel, jnp.asarray(sim), jnp.asarray(vals),
                              True, True, jnp.asarray(drop))
    uct_backup.backup_arena(tcfg, ta, act, tsel, torch.from_numpy(sim[None]),
                            torch.from_numpy(vals[None]), True,
                            torch.from_numpy(drop[None].astype(np.int32)))
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(ta, k).numpy()[0],
                                      np.asarray(getattr(jb, k)), err_msg=k)


@pytest.mark.parametrize("name", list(tree_cases.HAZARDS))
def test_select_matches_jax_intree_on_hazards(name):
    """The Selection kernel's hazard cases (tests/tree_cases.py), which the
    card holds the kernel to its plain version on: here the plain version
    (the wrapper on CPU tensors) against repro.core.intree."""
    tcfg, arrays, p = tree_cases.hazard(name)
    cfg = jtree.TreeConfig(**dataclasses.asdict(tcfg))
    jt = jtree.UCTree(**{k: jnp.asarray(v) for k, v in arrays.items()})
    jt, jsel = jintree.select_batch(cfg, jt, p)
    ta = as_arena(from_numpy(arrays, "cpu"))
    tsel = uct_select.select_arena(tcfg, ta, one(), p)
    for k in tintree.SEL_FIELDS:
        np.testing.assert_array_equal(getattr(tsel, k).numpy()[0],
                                      np.asarray(getattr(jsel, k)), err_msg=k)
    np.testing.assert_array_equal(ta.edge_VL.numpy()[0], np.asarray(jt.edge_VL))
    np.testing.assert_array_equal(ta.node_O.numpy()[0], np.asarray(jt.node_O))


def _small():
    cfg = TCfg(X=32, F=4, D=3)
    return cfg, init_arena(cfg, 2, device="cpu"), torch.ones(2, dtype=torch.int32)


def test_select_wrapper_rejects_bad_inputs():
    cfg, arena, act = _small()
    uct_select.select_arena(cfg, arena, act, 2)        # the good call
    with pytest.raises(TypeError, match="dtype"):
        uct_select.select_arena(cfg, arena, act.long(), 2)
    with pytest.raises(ValueError, match="shape"):
        uct_select.select_arena(cfg, arena, torch.ones(3, dtype=torch.int32), 2)
    for field, bad in (
            ("edge_W", lambda t: t.to(torch.int64)),
            ("log_table", lambda t: t.to(torch.float64)),
            ("node_N", lambda t: t[:, :-1]),
            ("child", lambda t: t.transpose(0, 1).contiguous().transpose(0, 1))):
        a = dataclasses.replace(arena, **{field: bad(getattr(arena, field))})
        with pytest.raises((TypeError, ValueError), match=field):
            uct_select.select_arena(cfg, a, act, 2)
    with pytest.raises(ValueError, match="cfg"):
        uct_select.select_arena(TCfg(X=64, F=4, D=3), arena, act, 2)


def test_select_shared_memory_limit():
    """The check select_arena makes before a launch on the card: 20 B of
    shared memory a worker within the 227 KB of a block, so p <= 11,622.
    The plain version on CPU tensors has no such limit."""
    uct_select.check_shared_memory(232_448 // 20)
    with pytest.raises(ValueError, match="p=11623 needs 232460 B .* 227 KB"):
        uct_select.check_shared_memory(232_448 // 20 + 1)


def test_stamped_selection_builds_apart():
    """chip_smoke.py's stamped copy of the Selection kernel is uct_select.cu
    built with -DUCT_SELECT_STAMPS into a library of its own name and
    hash, so the wrapper, which loads uct_select by name, never gets it."""
    source, flags = build.VARIANTS["uct_select_stamps"]
    assert (source, flags) == (uct_select.NAME, ["-DUCT_SELECT_STAMPS"])
    plain = build.library_path(uct_select.NAME)
    stamped = build.library_path("uct_select_stamps")
    assert plain.name.startswith("libuct_select-")
    assert stamped.name.startswith("libuct_select_stamps-")
    assert plain.name[-19:] != stamped.name[-19:]          # the hash
    text = (build.CSRC / f"{source}.cu").read_text()
    assert "#ifdef UCT_SELECT_STAMPS" in text and "uct_select_cycles_read" in text


def test_backup_wrapper_rejects_bad_inputs():
    cfg, arena, act = _small()
    sel = uct_select.select_arena(cfg, arena, act, 3)
    z = torch.zeros((2, 3), dtype=torch.int32)
    uct_backup.backup_arena(cfg, arena, act, sel, z, z)  # the good call
    with pytest.raises(TypeError, match="values_fx"):
        uct_backup.backup_arena(cfg, arena, act, sel, z, z.float())
    with pytest.raises(ValueError, match="sim_nodes"):
        uct_backup.backup_arena(cfg, arena, act, sel, z[:1], z)
    with pytest.raises(TypeError, match="dropped"):
        uct_backup.backup_arena(cfg, arena, act, sel, z, z, False, z.bool())
    strided = torch.zeros((3, 2), dtype=torch.int32).t()    # [2, 3] view
    with pytest.raises(ValueError, match="contiguous"):
        uct_backup.backup_arena(cfg, arena, act, sel, strided, z)
