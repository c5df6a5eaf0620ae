"""Port vs JAX package: fixed-point encoding, the ln table and edge scoring.

The same numpy inputs go through repro (numpy backend) and repro_torch
(torch on the CPU); every output is an int32 (or the f32 ln table)
compared with zero tolerance — the scoring spec is integer statistics
plus correctly rounded f32 ops (src/repro/core/scoring.py:4-10).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import fixedpoint as jfx
from repro.core import scoring as jscoring
from repro.core.tree import make_log_table as j_log_table
from repro_torch.core import fixedpoint as tfx
from repro_torch.core import scoring as tscoring
from repro_torch.core.tree import TreeConfig as TCfg
from repro_torch.core.tree import make_log_table as t_log_table
from test_kernels_uct import TREE_SWEEP, grow_tree

CFG_IDS = lambda c: f"F{c.F}-D{c.D}-{c.vl_mode}-{c.score_fn}"


def jax_arrays(tree) -> dict:
    """A JAX package tree as the snapshot dict of numpy arrays."""
    return {f.name: np.array(getattr(tree, f.name))
            for f in dataclasses.fields(tree)}


def port_cfg(cfg) -> TCfg:
    return TCfg(**dataclasses.asdict(cfg))


def test_encode_ties_and_clip_edges():
    s = 1.0 / 65536
    x = np.array([0.5 * s, 1.5 * s, 2.5 * s, -0.5 * s, -1.5 * s, -2.5 * s,
                  3.5 * s, 0.0, -0.0, 1.0, -1.0, 2047.99998, 2048.0, -2048.0,
                  -2048.00002, 1e9, -1e9, np.inf, -np.inf, 1.2345678],
                 np.float32)
    want = np.asarray(jfx.encode(x))
    np.testing.assert_array_equal(tfx.encode(torch.from_numpy(x)).numpy(), want)
    np.testing.assert_array_equal(tfx.encode(x), want)
    assert tfx.encode(torch.from_numpy(x)).dtype == torch.int32


def test_encode_random_and_decode():
    rng = np.random.RandomState(0)
    x = (rng.standard_normal(4096) * rng.choice([1e-4, 1.0, 1e3, 1e5], 4096)
         ).astype(np.float32)
    want = np.asarray(jfx.encode(x))
    np.testing.assert_array_equal(tfx.encode(torch.from_numpy(x)).numpy(), want)
    fx = rng.randint(-2**27, 2**27, 1000).astype(np.int32)
    np.testing.assert_array_equal(
        tfx.decode(torch.from_numpy(fx)).numpy(), np.asarray(jfx.decode(fx)))
    assert tfx.encode_scalar(0.5) == jfx.encode_scalar(0.5)


@pytest.mark.parametrize("x", [2, 64, 56_000])
def test_log_table(x):
    np.testing.assert_array_equal(t_log_table(x), j_log_table(x))


def _score_inputs(arrays, rng, vl=True):
    """Per-node rows of a grown tree, with some in-flight counts added."""
    n = int(arrays["size"])
    edge_VL = arrays["edge_VL"][:n].copy()
    node_O = arrays["node_O"][:n].copy()
    if vl:
        edge_VL += rng.randint(0, 3, edge_VL.shape).astype(np.int32)
        node_O += rng.randint(0, 3, node_O.shape).astype(np.int32)
    return dict(
        child=arrays["child"][:n], edge_N=arrays["edge_N"][:n],
        edge_W=arrays["edge_W"][:n], edge_VL=edge_VL,
        edge_P=arrays["edge_P"][:n], node_N=arrays["node_N"][:n, None],
        node_O=node_O[:, None], num_actions=arrays["num_actions"][:n, None])


@pytest.mark.parametrize("cfg", TREE_SWEEP, ids=CFG_IDS)
def test_edge_scores_match_jax(cfg):
    arrays = jax_arrays(grow_tree(cfg, supersteps=3, p=6))
    rng = np.random.RandomState(1)
    for vl in (False, True):
        kw = _score_inputs(arrays, rng, vl)
        if cfg.score_fn == "puct":   # give the prior term real values
            kw["edge_P"] = rng.randint(0, 65537, kw["edge_P"].shape).astype(np.int32)
        want = jscoring.edge_scores_fx(cfg, log_table=arrays["log_table"],
                                       xp=np, **kw)
        got = tscoring.edge_scores_fx(
            port_cfg(cfg), log_table=torch.from_numpy(arrays["log_table"]),
            **{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in kw.items()})
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            tscoring.argmax_first(got).numpy(),
            np.asarray(jscoring.argmax_first(want, xp=np)))


def test_argmax_first_ties_go_to_lowest_lane():
    s = torch.tensor([[3, 7, 7, 1], [5, 5, 5, 5], [-1, -2, -1, -9]],
                     dtype=torch.int32)
    assert tscoring.argmax_first(s).tolist() == [1, 0, 0]


@pytest.mark.parametrize("cfg", TREE_SWEEP, ids=CFG_IDS)
def test_is_leaf_matches_jax(cfg):
    rng = np.random.RandomState(2)
    kw = dict(num_expanded=rng.randint(0, 5, 200).astype(np.int32),
              num_actions=rng.randint(0, 5, 200).astype(np.int32),
              terminal=(rng.rand(200) < 0.2).astype(np.int32),
              depth=rng.randint(0, cfg.D + 2, 200).astype(np.int32))
    want = jscoring.is_leaf(cfg, xp=np, **kw)
    got = tscoring.is_leaf(port_cfg(cfg),
                           **{k: torch.from_numpy(v) for k, v in kw.items()})
    np.testing.assert_array_equal(got.numpy(), want)
