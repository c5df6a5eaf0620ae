"""The port's launch tooling against the JAX package's, on the CPU:
logical-axis sharding rules and per-device bytes over the production
meshes, the meta-device parameter tree and its axes, the gloo process
groups and meshes, the collective recorder, restore onto a mesh, the MoE
shard-map path on a gloo world of two against the JAX path on two forced
host devices, the operation counter against the JAX jaxpr walker, the
dry run, and the range-analysis helpers of core/."""

import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import configs as jconfigs
from repro.core import fixedpoint as jfx
from repro.core.tree import TreeConfig as JTreeConfig
from repro.launch import roofline as jroof
from repro.launch import specs as jspecs
from repro.models import lm as jlm
from repro.models import sharding as jsh
from repro.models import steps as jsteps
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch import configs
from repro_torch.core import fixedpoint as fx
from repro_torch.core.tree import TreeConfig
from repro_torch.distributed.checkpoint import (restore_checkpoint,
                                                save_checkpoint)
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import collectives, dryrun, roofline, specs
from repro_torch.launch.distributed_init import init_distributed, is_primary
from repro_torch.launch.mesh import (MeshShape, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models import lm, moe, sharding as sh, steps
from repro_torch.optim import make_optimizer
from repro_torch.pytree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
import torch_worlds  # noqa: E402

MESHES = {False: (("data", "model"), (16, 16)),
          True: (("pod", "data", "model"), (2, 16, 16))}


class FakeMesh:
    """The JAX side's mesh: names and sizes only (test_param_spec_fallbacks'
    FakeMesh)."""

    def __init__(self, names, sizes):
        self.axis_names, self.shape = names, dict(zip(names, sizes))
        self.size = int(np.prod(sizes))


class FakeNamedSharding:
    """Stands for jax.sharding.NamedSharding over a FakeMesh: the JAX
    byte counts read only its spec."""

    def __init__(self, mesh, spec):
        self.spec = spec


def norm(spec) -> tuple:
    """A spec's entries as tuples of names (JAX's PartitionSpec keeps a
    1-tuple or a bare name)."""
    return tuple(() if e is None else (e,) if isinstance(e, str) else tuple(e)
                 for e in spec)


class Box:
    def __init__(self, v):
        self.v = v


def jax_leaves(tree, fn, *rest):
    """fn over the axes leaves of a JAX axes tree (and `rest`), in leaf
    order."""
    out = jax.tree.map(lambda *a: Box(fn(*a)), tree, *rest,
                       is_leaf=sh.is_axes)
    return [b.v for b in jax.tree.leaves(out, is_leaf=lambda x: isinstance(x, Box))]


def axes_leaves(tree) -> list:
    if sh.is_axes(tree):
        return [tree]
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in axes_leaves(tree[k])]
    return [l for c in tree for l in axes_leaves(c)]


# ------------------------------------------------------- params and axes

@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_axes_and_shapes_match_jax(arch):
    """param_axes equals the JAX package's leaf by leaf; param_shapes is
    init_params' tree on meta (nothing allocated, deepseek-v3's 671e9
    parameters included) with the JAX package's shapes and dtypes."""
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    assert axes_leaves(lm.param_axes(cfg)) == jax.tree.leaves(
        jlm.param_axes(jcfg), is_leaf=sh.is_axes)
    shapes = tree_leaves(lm.param_shapes(cfg))
    want = jax.tree.leaves(jlm.param_shapes(jcfg))
    assert all(t.device.type == "meta" for t in shapes)
    assert [(tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for t in shapes] == [(tuple(w.shape), str(w.dtype)) for w in want]


def test_param_shapes_structure_matches_init():
    cfg = configs.get_config("deepseek-v3-671b", smoke=True)
    real = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    meta = lm.param_shapes(cfg)
    assert [(t.shape, t.dtype) for t in tree_leaves(real)] == [
        (t.shape, t.dtype) for t in tree_leaves(meta)]


# --------------------------------------------- rules, specs, bytes (JAX)

@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_specs_and_bytes_match_jax(arch, monkeypatch):
    """Every (shape x production mesh x optimized) cell of the arch's full
    config: the rules, every parameter's spec and the parameter, optimizer
    and cache bytes per device equal the JAX package's (computed on a
    FakeMesh from jax.eval_shape shapes)."""
    monkeypatch.setattr(jax.sharding, "NamedSharding", FakeNamedSharding)
    jcfg0, cfg0 = jconfigs.get_config(arch), configs.get_config(arch)
    for name in jconfigs.SHAPES:
        jshape, shape = jconfigs.SHAPES[name], configs.SHAPES[name]
        assert dataclass_dict(jshape) == dataclass_dict(shape)
        for multi in (False, True):
            jm, mesh = FakeMesh(*MESHES[multi]), make_production_mesh(
                multi_pod=multi)
            for opt in (False, True):
                jcfg = jspecs.config_for(jcfg0, jshape, opt)
                cfg = specs.config_for(cfg0, shape, opt)
                jr, r = jspecs.rules_for(jcfg, jshape, opt), specs.rules_for(
                    cfg, shape, opt)
                assert dataclass_dict(jr) == dataclass_dict(r)
                ja, jp = jlm.param_axes(jcfg), jlm.param_shapes(jcfg)
                a, p = lm.param_axes(cfg), lm.param_shapes(cfg)
                jspec = jax_leaves(ja, lambda ax, s: norm(
                    jsh.spec_for_param(jm, jr, ax, s.shape)), jp)
                shd = sh.make_param_shardings(mesh, r, a, p)
                assert [norm(s.spec) for s in tree_leaves(shd)] == jspec, \
                    (name, multi, opt)
                jshd = jax.tree.map(lambda ax, s: FakeNamedSharding(
                    jm, jsh.spec_for_param(jm, jr, ax, s.shape)), ja, jp,
                    is_leaf=sh.is_axes)
                assert specs.sharded_bytes_per_device(p, shd, mesh) == \
                    jspecs.sharded_bytes_per_device(jp, jshd, jm)
                if shape.kind == "train":
                    jn, (jinit, _) = jspecs.optimizer_for(jcfg)
                    n, (init, _) = specs.optimizer_for(cfg)
                    jo, o = jax.eval_shape(jinit, jp), init(p)
                    jos = jspecs.opt_state_shardings(jm, jr, jn, ja, jp, jo)
                    os_ = specs.opt_state_shardings(mesh, r, n, a, p, o)
                    assert specs.sharded_bytes_per_device(o, os_, mesh) == \
                        jspecs.sharded_bytes_per_device(jo, jos, jm)
                else:
                    B, S = shape.global_batch, shape.seq_len
                    jc = jspecs.cache_shapes(jcfg, B, S)
                    c = specs.cache_shapes(cfg, B, S)
                    assert specs.sharded_bytes_per_device(
                        c, specs.cache_shardings(mesh, r, c), mesh) == \
                        jspecs.sharded_bytes_per_device(
                            jc, jspecs.cache_shardings(jm, jr, jc), jm)
                jt, t = jspecs.token_specs(jcfg, jshape), specs.token_specs(
                    cfg, shape)
                assert {k: tuple(v.shape) for k, v in jt.items()} == {
                    k: tuple(v.shape) for k, v in t.items()}
                jb = jspecs.batch_spec_shardings(jm, jr, jcfg, jshape, jt)
                b = specs.batch_spec_shardings(mesh, r, cfg, shape, t)
                assert {k: norm(v.spec) for k, v in jb.items()} == {
                    k: norm(v.spec) for k, v in b.items()}


def dataclass_dict(x) -> dict:
    return {k: getattr(x, k) for k in x.__dataclass_fields__}


def test_cell_supported_and_production_meshes():
    for arch in configs.ARCH_IDS:
        for name, shape in configs.SHAPES.items():
            assert configs.cell_supported(configs.get_config(arch), shape) == \
                jconfigs.cell_supported(jconfigs.get_config(arch),
                                        jconfigs.SHAPES[name])
    for multi, (names, sizes) in MESHES.items():
        m = make_production_mesh(multi_pod=multi)
        assert m.axis_names == names and m.shape == dict(zip(names, sizes))
        assert m.size == int(np.prod(sizes))


# ------------------------------------------------- process groups, meshes

@pytest.fixture
def world_of_one(tmp_path, monkeypatch):
    """A gloo world of one through init_distributed (a FileStore under
    tmp_path), destroyed afterwards."""
    for k in ("REPRO_NUM_PROCESSES", "REPRO_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    info = init_distributed("cpu", store=dist.FileStore(
        str(tmp_path / "store"), 1))
    try:
        yield info
    finally:
        dist.destroy_process_group()


def test_init_distributed_world_of_one(world_of_one):
    assert world_of_one == {"num_processes": 1, "process_id": 0,
                            "coordinator": "localhost:9911",
                            "backend": "gloo"}
    assert dist.get_world_size() == 1 and is_primary()
    mesh = make_host_mesh(device="cpu")
    assert mesh.mesh_dim_names == ("data", "model")
    assert sh.mesh_sizes(mesh) == {"data": 1, "model": 1}


def test_card_entry_points_raise_without_a_card():
    """make_host_mesh and init_distributed default to the card and NCCL;
    with no card they raise and start no group."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_distributed()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_host_mesh()
    assert not dist.is_initialized()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_collectives_recorded_bit_exact(world_of_one, dtype):
    """all_reduce, all_gather and broadcast on a world of one return the
    seeded tensor bit for bit, and the recorder counts each one's result
    bytes exactly."""
    mesh = make_host_mesh(device="cpu")
    x = torch.from_numpy(np.random.RandomState(0).randn(8, 12).astype(
        np.float32)).to(dtype)
    t = x.clone()
    with collectives.record() as rec:
        dist.all_reduce(t, group=mesh.get_group("model"))
        parts = [torch.empty_like(t)]
        dist.all_gather(parts, t, group=mesh.get_group("data"))
        dist.broadcast(t, src=0)
    assert torch.equal(t, x) and torch.equal(parts[0], x)
    n = x.numel() * x.element_size()
    assert rec.bytes == {"all_reduce": n, "all_gather": n,
                         "reduce_scatter": 0, "all_to_all": 0,
                         "broadcast": n, "total": 3 * n}
    assert dict(rec.ops) == {"all_reduce": 1, "all_gather": 1, "broadcast": 1}


def test_constrain(world_of_one):
    """No mesh context: the input itself.  Under a mesh context a DTensor
    is redistributed to spec_for_act's placements; a plain tensor, the
    whole value on every rank, is returned as it is."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    x = torch.randn(4, 6)
    sh.set_context(None)
    assert sh.constrain(x, ("batch", "embed")) is x
    mesh = make_host_mesh(device="cpu")
    d = distribute_tensor(x, mesh, [Replicate(), Shard(1)])
    sh.set_context(mesh, sh.Rules(batch=("data",)))
    try:
        assert sh.constrain(x, ("batch", "embed")) is x
        out = sh.constrain(d, ("batch", "embed"))
    finally:
        sh.set_context(None)
    assert out.placements == (Shard(0), Replicate())
    assert torch.equal(out.full_tensor(), x)


def test_restore_onto_mesh(world_of_one, tmp_path):
    """The twin of test_checkpoint.py's test_elastic_restore_new_sharding
    (which asserts jax's NamedSharding): a tree saved from plain tensors
    restores onto a 1x1 gloo mesh, with make_param_shardings' tree and
    with a (mesh, placements) pair a leaf, every leaf a DTensor on that
    mesh equal to the saved leaf bit for bit."""
    from torch.distributed.tensor import DTensor

    cfg = configs.get_config("llama3.2-1b", smoke=True)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    save_checkpoint(tmp_path / "ck", 3, params)
    mesh = make_host_mesh(device="cpu")
    shd = sh.make_param_shardings(mesh, sh.Rules(), lm.param_axes(cfg),
                                  params)
    pairs = sh.make_param_shardings(mesh, sh.Rules(), lm.param_axes(cfg),
                                    params)
    pairs = jax.tree.map(lambda s: (mesh, s.placements), pairs)
    for layout in (shd, pairs):
        out, _ = restore_checkpoint(tmp_path / "ck", 3,
                                    lm.param_shapes(cfg), layout)
        for a, b in zip(tree_leaves(params), tree_leaves(out)):
            assert isinstance(b, DTensor) and b.device_mesh is mesh
            assert b.dtype == a.dtype and torch.equal(b.full_tensor(), a)
    out, _ = restore_checkpoint(tmp_path / "ck", 3, params, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                 tree_leaves(out)))


# ---------------------------------------------------- MoE shard-map path

MOE_ARCHS = ("mixtral-8x22b", "deepseek-v3-671b")
Y_TOL = 1e-5        # the JAX path's own y against its dense path (1.3e-6)
AUX_TOL = 1e-6      # a float reduction in another order (1 ulp seen)


@pytest.fixture(scope="module")
def shard_map_runs():
    """(the JAX package's results on two forced host devices, the port's
    results on each rank of a gloo world of two)."""
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=2",
                   PYTHONPATH=str(ROOT / "src"))
        subprocess.run([sys.executable, str(ROOT / "tests/moe_shard_map_jax.py"),
                        f"{tmp}/jax.npz"], env=env, check=True, timeout=120)
        jax_out = dict(np.load(f"{tmp}/jax.npz"))
        ranks = torch_worlds.run_world(torch_worlds.moe_shard_map_worker, 2,
                                       tmp, f"{tmp}/jax.npz")
    return jax_out, ranks


@pytest.mark.parametrize("mesh", ["2x1", "1x2"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_shard_map_matches_jax(shard_map_runs, arch, mesh):
    """Every rank returns the same global y, within Y_TOL of the JAX
    package's _moe_shard_map; aux is data shard 0's own aux (the port's
    dense aux over the first half of the tokens on the (2, 1) mesh), as
    the JAX path returns it, not the global one; the recorder counts the
    model all-reduce of the local y, the data all-gather of the global y
    and the aux broadcast."""
    jax_out, ranks = shard_map_runs
    cfg = configs.get_config(arch, smoke=True)
    (y0, aux0, b0), (y1, aux1, _) = ranks[0][f"{arch}:{mesh}"], \
        ranks[1][f"{arch}:{mesh}"]
    assert np.array_equal(y0, y1) and np.array_equal(aux0, aux1)
    assert np.abs(y0 - jax_out[f"{arch}:{mesh}:y"]).max() <= Y_TOL
    assert abs(float(aux0) - float(jax_out[f"{arch}:{mesh}:aux"])) <= AUX_TOL
    p = torch_worlds.moe_params(jax_out, arch)
    x = torch.from_numpy(jax_out[f"{arch}:x"])
    local = x[: x.shape[0] // 2] if mesh == "2x1" else x
    _, want = moe.moe_forward(cfg, p, local)
    assert float(aux0) == float(want)
    if mesh == "2x1":      # the JAX path's aux is shard 0's, too
        assert abs(float(jax_out[f"{arch}:{mesh}:aux"])
                   - float(jax_out[f"{arch}:dense_shard0:aux"])) <= AUX_TOL
        assert abs(float(aux0) - float(jax_out[f"{arch}:dense:aux"])) > 1e-4
    T, d = x.shape[0] * x.shape[1], cfg.d_model
    T_loc = T // 2 if mesh == "2x1" else T
    assert b0["all_reduce"] == T_loc * d * 4
    assert b0["all_gather"] == T * d * 4
    assert b0["broadcast"] == 4


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_shard_map_refuses_expert_sharding(shard_map_runs, arch):
    """Rules(shard_experts=True) with the experts divisible by the model
    axis (where the JAX path fails with an einsum shape error) raises a
    ValueError naming the rule, on every rank."""
    for r in shard_map_runs[1]:
        assert "shard_experts=True" in r[f"{arch}:raised"]


# --------------------------------------------------- operation counting

def test_op_costs_dot_flops_exact():
    a, b = torch.empty(128, 256, device="meta"), torch.empty(
        256, 64, device="meta")
    c = roofline.op_costs(lambda a, b: a @ b, a, b)
    assert c["flops"] == c["dot_flops_f32"] == 2 * 128 * 256 * 64
    assert c["bytes"] == 4 * (128 * 256 + 256 * 64 + 128 * 64)


def test_op_costs_python_loop_counted_each_time():
    x = torch.empty(64, 64, device="meta")

    def f(x):
        for _ in range(7):
            x = x @ x
        return x
    assert roofline.op_costs(f, x)["dot_flops_f32"] == 7 * 2 * 64 ** 3


def test_op_costs_nested_loop():
    x = torch.empty(32, 32, dtype=torch.bfloat16, device="meta")

    def f(x):
        for _ in range(5):
            for _ in range(3):
                x = x @ x
        return x
    c = roofline.op_costs(f, x)
    assert c["dot_flops_bf16"] == 15 * 2 * 32 ** 3 and c["dot_flops_f32"] == 0


def test_op_costs_grad_includes_recompute():
    """A backward counts its products, and a checkpointed block's
    recomputation on top: at least 2.5x the forward's products, as the
    JAX walker's remat test holds."""
    from torch.utils.checkpoint import checkpoint

    w = torch.empty(64, 64, device="meta", requires_grad=True)
    x = torch.empty(8, 64, device="meta")

    def loss(w, x):
        h = checkpoint(lambda a: torch.tanh(a @ w), x, use_reentrant=False)
        return torch.sum(h @ w)

    base = roofline.op_costs(loss, w, x)
    g = roofline.op_costs(lambda w, x: loss(w, x).backward(), w, x)
    plain = roofline.op_costs(lambda w, x: torch.sum(torch.tanh(x @ w) @ w)
                              .backward(), w, x)
    assert g["flops"] > 2.5 * base["flops"]
    assert g["dot_flops_f32"] == plain["dot_flops_f32"] + 2 * 8 * 64 * 64


def test_bound_s_by_dtype():
    c = {"dot_flops_bf16": 989e12, "dot_flops_f32": 67e12, "other_flops": 0,
         "bytes": 3.35e12}
    assert roofline.bound_s(c)["compute_s"] == pytest.approx(2.0)
    assert roofline.bound_s(c, tf32=True)["compute_s"] == pytest.approx(
        1 + 67 / 495)
    assert roofline.bound_s(dict(c, dot_flops_bf16=0, dot_flops_f32=0))[
        "bound_by"] == "bytes"


def jax_dot_flops(fn, *args) -> int:
    """The JAX walker's dot_general FLOPs of fn (scan lengths multiplied
    through, roofline._dot_flops per product)."""
    total = 0

    def walk(jaxpr, mult):
        nonlocal total
        for e in jaxpr.eqns:
            sub = mult * (int(e.params["length"]) if e.primitive.name == "scan"
                          else 1)
            if e.primitive.name == "dot_general":
                total += mult * jroof._dot_flops(e)
            for s in jroof._sub_jaxprs(e.params):
                walk(s.jaxpr, sub)
    walk(jax.make_jaxpr(fn)(*args).jaxpr, 1)
    return total


# The port's total FLOPs of a step against the JAX walker's: the products
# are equal, the other ops differ by how each package spells them (torch's
# softmax is one op, JAX's five; torch's embedding a gather, JAX's a take
# and a convert).  Measured on SMOKE llama3.2-1b, B=2, S=64: the forward
# 0.990, the train step (JAX without its remat) 0.980 of the JAX count.
TOTAL_TOL = 0.03

LLAMA_B, LLAMA_S = 2, 64


@pytest.fixture(scope="module")
def llama_smoke():
    jcfg = jconfigs.get_config("llama3.2-1b", smoke=True)
    cfg = configs.get_config("llama3.2-1b", smoke=True)
    tok = jax.ShapeDtypeStruct((LLAMA_B, LLAMA_S), jnp.int32)
    ttok = torch.zeros((LLAMA_B, LLAMA_S), dtype=torch.int32, device="meta")
    return jcfg, cfg, jlm.param_shapes(jcfg), lm.param_shapes(cfg), tok, ttok


def test_prefill_dot_flops_match_jax(llama_smoke):
    """The port's prefill products equal the JAX walker's but for the
    unembedding of the S-1 positions before the last, which the port's
    prefill skips (models/steps.py); the forward, which unembeds every
    position in both, has the same products and its total within
    TOTAL_TOL."""
    jcfg, cfg, jp, p, tok, ttok = llama_smoke
    jc = jax.eval_shape(lambda: jlm.init_caches(jcfg, LLAMA_B, LLAMA_S))
    jpre = jsteps.make_prefill_step(jcfg, impl="naive")
    jd = jax_dot_flops(lambda p, t, c: jpre(p, t, c), jp, tok, jc)
    c = roofline.op_costs(steps.make_prefill_step(cfg, impl="naive"), p, ttok,
                          lm.init_caches(cfg, LLAMA_B, LLAMA_S, "meta"))
    skipped = 2 * LLAMA_B * (LLAMA_S - 1) * cfg.d_model * cfg.padded_vocab
    assert c["dot_flops_f32"] + skipped == jd and c["dot_flops_bf16"] == 0
    jfwd = lambda p, t: jlm.forward(jcfg, p, t, impl="naive")[0]
    f = roofline.op_costs(lambda p, t: lm.forward(cfg, p, t, impl="naive"),
                          p, ttok)
    assert f["dot_flops_f32"] == jax_dot_flops(jfwd, jp, tok)
    assert f["flops"] == pytest.approx(jroof.jaxpr_costs(jfwd, jp, tok)[
        "flops"], rel=TOTAL_TOL)


def test_train_step_dot_flops_match_jax(llama_smoke, monkeypatch):
    """The train step's products (forward, backward and the optimizer)
    equal the JAX walker's once the JAX step's remat is taken out
    (jax.checkpoint over each scan body: its grad jaxpr recomputes the
    layers' forward, which the port's step does not), and the JAX step
    with its remat counts more; the totals within TOTAL_TOL."""
    jcfg, cfg, jp, p, tok, ttok = llama_smoke
    _, jupd = jmake_optimizer("adamw")
    init, upd = make_optimizer("adamw")
    jo = jax.eval_shape(jmake_optimizer("adamw")[0], jp)
    jstep = jsteps.make_train_step(jcfg, jupd, impl="naive")
    # a new function for each trace: make_jaxpr caches by function
    fn = lambda: (lambda p, o, b: jstep(p, o, 0, b))
    batch = {"tokens": tok, "labels": tok}
    c = roofline.op_costs(steps.make_train_step(cfg, upd, impl="naive"), p,
                          init(p), 0, {"tokens": ttok, "labels": ttok})
    with_remat = jax_dot_flops(fn(), jp, jo, batch)
    monkeypatch.setattr(jax, "checkpoint", lambda f, *a, **k: f)
    assert c["dot_flops_f32"] == jax_dot_flops(fn(), jp, jo, batch) < with_remat
    assert c["flops"] == pytest.approx(
        jroof.jaxpr_costs(fn(), jp, jo, batch)["flops"], rel=TOTAL_TOL)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_flash_report_counted_once(device):
    """Under op_costs the flash wrapper's work is its report alone: the
    plain version it runs on the CPU is not counted again, and on meta it
    returns an empty output of q's shape and launches nothing."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 96, 4, 32, generator=g).to(device)
    k = torch.randn(2, 96, 2, 32, generator=g).to(device)
    n0 = FA.launches
    c = roofline.op_costs(FA.flash_attention, q, k, k, causal=True, window=40)
    flops, nbytes = FA.costs(q, k, k, causal=True, window=40)
    pairs = sum(min(i + 1, 40) for i in range(96))
    assert flops == 4 * 2 * 4 * 32 * pairs
    assert c["flops"] == c["reported_flops"] == c["dot_flops_f32"] == flops
    assert c["bytes"] == c["reported_bytes"] == nbytes
    assert FA.launches == n0
    out = FA.flash_attention(q, k, k, causal=True, window=40)
    assert out.shape == q.shape and out.device.type == device


# -------------------------------------------------------------- dry run

TINY = {"train": configs.ShapeSpec("train_tiny", 64, 2, "train"),
        "prefill": configs.ShapeSpec("prefill_tiny", 64, 2, "prefill"),
        "decode": configs.ShapeSpec("decode_tiny", 64, 2, "decode")}


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_dryrun_smoke_steps_on_meta(arch, tmp_path):
    """Every SMOKE arch's train, prefill and decode steps run on meta
    tensors (no .item(), boolean-mask index or data-dependent shape on
    the path) and give a whole record."""
    one = MeshShape(("data", "model"), (1, 1))
    for kind, shape in TINY.items():
        rec = dryrun.run_cell(arch, None, False, smoke=True, shape=shape,
                              mesh=one, out_dir=tmp_path)
        assert rec["status"] == "ok", rec.get("traceback")
        assert rec["flops_global"] > 0 and rec["bytes_global"] > 0
        assert rec["state_bytes_device"] > 0 and rec["fits_hbm_state"]
        # one rank exchanges nothing
        assert rec["collectives"]["total"] == 0 and rec["collective_s"] == 0
        assert rec["collective_reason"] is None
        assert rec["dominant"] in ("compute_s", "memory_s", "collective_s")
        cfg = configs.get_config(arch, smoke=True)
        if kind == "prefill" and rec["impl"] == "flash":   # its reports
            attn = any(s.kind == "attn" for s in cfg.layer_specs())
            assert (rec["kernel_reported_flops"] > 0) == attn
        if kind == "train":
            assert rec["optimizer"] == specs.optimizer_for(cfg)[0]


def test_dryrun_cli_writes_records(tmp_path):
    """The CLI over one arch's decode and long-context cells on both
    production meshes: a JSON record a cell, long_500k skipped for a
    full-attention stack."""
    rc = dryrun.main(["--arch", "llama3.2-1b", "--smoke", "--shape",
                      "decode_32k", "--mesh", "both", "--out", str(tmp_path)])
    assert rc == 0
    recs = [json.loads(p.read_text()) for p in sorted(tmp_path.glob("*.json"))]
    assert [r["mesh"] for r in recs] == ["16x16", "2x16x16"]
    # a decode step writes its cache at one position, which DTensor
    # cannot do on a cache sharded over its length
    assert all(r["status"] == "ok" and r["collectives"] is None and
               r["collective_reason"] == "aten.index_put_.default"
               for r in recs)
    rec = dryrun.run_cell("llama3.2-1b", "long_500k", False, smoke=True,
                          out_dir=tmp_path)
    assert rec["status"] == "skipped"


# ----------------------------------------- the dry run's collective term

A11B_TRAIN = configs.ShapeSpec("train_tiny", 32, 8, "train")   # B=8, S=32


def llama_leaf_bytes(cfg) -> int:
    return sum(t.numel() * t.element_size()
               for t in tree_leaves(lm.param_shapes(cfg)))


def test_dryrun_data_parallel_collectives_hand_count():
    """SMOKE llama's train step on (data=4, model=1): every parameter is
    replicated (model=1, no FSDP) and the batch split 4 ways, so each
    gradient is a sum over the data shards, all-reduced once at its
    parameter's bytes, and the loss mask's token count (the masked mean's
    f32 denominator) is all-reduced once; nothing else moves."""
    cfg = configs.get_config("llama3.2-1b", smoke=True)
    rec = dryrun.count_collectives(cfg, A11B_TRAIN,
                                   MeshShape(("data", "model"), (4, 1)))
    assert rec["collective_reason"] is None
    n_leaves = len(tree_leaves(lm.param_shapes(cfg)))
    want = llama_leaf_bytes(cfg) + 4
    assert rec["collectives"] == {
        "all_reduce": want, "all_gather": 0, "reduce_scatter": 0,
        "all_to_all": 0, "broadcast": 0, "total": want}
    assert rec["collective_ops"] == {"all_reduce": n_leaves + 1}
    # the 4 ranks lie in one node: NVLink
    assert rec["collective_links"] == {"nvlink": want, "network": 0}
    assert rec["collective_s"] == want / dryrun.NVLINK_BW


def model_parallel_forward(cfg, B=8, S=32):
    """lm.forward of SMOKE llama on a fake (data=1, model=2) world with
    the parameters and tokens placed by the specs; the recorder."""
    from torch.distributed.tensor.experimental import implicit_replication

    mesh = MeshShape(("data", "model"), (1, 2))
    rules = sh.DEFAULT_RULES
    pshapes = lm.param_shapes(cfg)
    pshard = sh.make_param_shardings(mesh, rules, lm.param_axes(cfg), pshapes)
    tok = torch.empty((B, S), dtype=torch.int32, device="meta")
    tshard = specs.batch_spec_shardings(mesh, rules, cfg, A11B_TRAIN,
                                        {"tokens": tok})["tokens"]
    rec = collectives.record()
    with dryrun.fake_world(mesh) as dmesh:
        params = dryrun.placed(pshapes, pshard, dmesh)
        tokens = dryrun.placed(tok, tshard, dmesh)
        sh.set_context(dmesh, rules)
        try:
            with implicit_replication(), rec:
                lm.forward(cfg, params, tokens, impl="naive")
        finally:
            sh.set_context(None)
    return rec


def test_dryrun_model_parallel_collectives_hand_count():
    """SMOKE llama's forward on (data=1, model=2): the vocab-sharded
    embedding lookup and, in each layer, the heads-sharded attention
    output projection and the mlp-sharded down projection leave partial
    sums that ``constrain`` all-reduces: 1 + 2L all-reduces of the
    [B, S, d] f32 activations, and nothing else (the tied unembedding's
    logits stay vocab-sharded).  The whole train step also counts."""
    cfg = configs.get_config("llama3.2-1b", smoke=True)
    L = cfg.n_layers
    act = 8 * 32 * cfg.d_model * 4
    rec = model_parallel_forward(cfg)
    one = ("all_reduce", (8, 32, cfg.d_model), act)
    assert rec.calls == [one] * (1 + 2 * L)
    train = dryrun.count_collectives(cfg, A11B_TRAIN,
                                     MeshShape(("data", "model"), (1, 2)))
    assert train["collective_reason"] is None
    assert train["collectives"]["all_reduce"] >= (1 + 2 * L) * act


@pytest.fixture(scope="module")
def jax_dryrun(tmp_path_factory):
    """tests/dryrun_jax.py's record of the same cell on four forced host
    devices (a subprocess: JAX fixes its device count when it starts)."""
    out = tmp_path_factory.mktemp("dryrun_jax") / "out.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    subprocess.run([sys.executable, str(ROOT / "tests/dryrun_jax.py"),
                    str(out)], env=env, check=True, timeout=600,
                   capture_output=True)
    return json.loads(out.read_text())


def test_dryrun_collectives_beside_jax(jax_dryrun):
    """The JAX dry run's parsed bytes beside the port's count of the same
    cell.  Equal only where both partitioners must place the same
    collective: on (4, 1) both move gradients by all-reduce alone, and
    both all-reduce the embedding table's gradient whole ([512, 64] f32;
    XLA once for each use of the tied table, the port once for their
    autograd sum); on (1, 2) both all-reduce the row-parallel projections'
    [B, S, d] f32 partial sums.  The totals differ: XLA reduces the
    stacked layers' gradients inside the layer loop (a layer's slice,
    counted once) and its remat recomputes the forward's all-reduces."""
    cfg = configs.get_config("llama3.2-1b", smoke=True)
    dp = dryrun.count_collectives(cfg, A11B_TRAIN,
                                  MeshShape(("data", "model"), (4, 1)))
    j = jax_dryrun["4x1"]
    assert set(j["collective_bytes"]) == {"all-reduce", "total"}
    assert dp["collectives"]["total"] == dp["collectives"]["all_reduce"]
    table = ["f32", [cfg.vocab, cfg.d_model]]
    assert j["all_reduce_shapes"].count(table) == 2
    assert dp["collectives"]["all_reduce"] == llama_leaf_bytes(cfg) + 4
    print("(4, 1) all-reduce bytes a device: JAX", j["collective_bytes"],
          "scaled", j["collectives_scaled"], "port", dp["collectives"])
    mp = model_parallel_forward(cfg)
    act = ["f32", [8, 32, cfg.d_model]]
    assert act in jax_dryrun["1x2"]["all_reduce_shapes"]
    assert {(k, s) for k, s, _ in mp.calls} == {("all_reduce",
                                                 (8, 32, cfg.d_model))}


def test_dryrun_every_smoke_arch_counts_or_names_the_op():
    """Every SMOKE arch's prefill and decode cells on a (2, 2) fake world:
    a collective count, or a reason naming the op DTensor cannot shard."""
    mesh = MeshShape(("data", "model"), (2, 2))
    for arch in configs.ARCH_IDS:
        cfg = configs.get_config(arch, smoke=True)
        for kind in ("prefill", "decode"):
            rec = dryrun.count_collectives(
                cfg, configs.ShapeSpec(f"{kind}_tiny", 64, 4, kind), mesh)
            if rec["collectives"] is None:
                assert re.match(r"(aten|c10d)", rec["collective_reason"]), (
                    arch, kind, rec["collective_reason"])
            else:
                assert rec["collective_s"] >= 0.0
                assert sum(rec["collective_links"].values()) == \
                    rec["collectives"]["total"]


def test_link_of_and_counting_mesh():
    assert dryrun.link_of(range(8)) == "nvlink"
    assert dryrun.link_of([0, 2, 4, 6]) == "nvlink"
    assert dryrun.link_of(range(4, 12)) == "network"
    assert dryrun.link_of(range(0, 256, 16)) == "network"
    m = dryrun.counting_mesh(make_production_mesh(multi_pod=True))
    assert (m.axis_names, m.sizes) == (("data", "model"), (32, 16))
    one = make_production_mesh()
    assert dryrun.counting_mesh(one) is one


# ------------------------------------------------- core: range analysis

def test_range_helpers_match_jax():
    for ub in (0.5, 2.0, 3.3, 1e3, 1e6):
        assert fx.integer_bits_for(ub) == jfx.integer_bits_for(ub)
    for args in ((1.0, 1.0, 56_000), (2.0, 1.4, 1), (1.0, 0.5, 48_000)):
        assert fx.uct_upper_bound(*args) == jfx.uct_upper_bound(*args)
    x = np.random.RandomState(0).randn(1000).astype(np.float32) * 1e3
    x[:4] = [0.0, -0.0, np.inf, -np.inf]
    want = jfx.f32_to_ordered_i32(x)
    assert np.array_equal(fx.f32_to_ordered_i32(x), want)
    t = fx.f32_to_ordered_i32(torch.from_numpy(x), xp=torch)
    assert t.dtype == torch.int32 and np.array_equal(t.numpy(), want)
    assert np.array_equal(fx.ordered_i32_to_f32(t, xp=torch).numpy(), x)
    order = np.argsort(x, kind="stable")
    up = np.diff(x[order]) > 0              # -0.0 and 0.0 compare equal
    assert np.all(np.diff(want[order])[up] > 0)


@pytest.mark.parametrize("score_fn", ["uct", "puct"])
def test_sram_bytes_match_jax(score_fn):
    for X, F in ((56_000, 6), (48_000, 36), (100, 3)):
        kw = dict(X=X, F=F, D=5, score_fn=score_fn)
        assert TreeConfig(**kw).sram_bytes() == JTreeConfig(**kw).sram_bytes()
