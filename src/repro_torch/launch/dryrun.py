"""The dry run on the meta device (the port of repro.launch.dryrun).

For each (arch x shape x mesh) cell:
  * the production mesh's shape (launch.mesh.make_production_mesh: 16x16
    single pod, 2x16x16 multi-pod) and the cell's sharding rules
    (launch.specs.rules_for);
  * the exact per-device bytes of the parameters, the optimizer state
    (train) and the caches (prefill, decode), from the meta shapes and the
    specs (``specs.sharded_bytes_per_device``), and whether they fit one
    H100's 80 GB;
  * the step (the train step for train_4k, the prefill or a decode step
    for the inference shapes) run once on meta tensors under
    ``roofline.op_costs``: its global FLOPs by dtype and bytes, and from
    them the H100 roofline terms ``compute_s`` and ``memory_s``, the
    ``dominant`` one, and the share of the FLOPs the model needs
    (``useful_flops_ratio``).  The step takes the port's own attention
    route: the train launcher's (``train.train_impl``: blockwise at 4k)
    and the serve prefill's (``serve.prefill_impl``: the flash kernel,
    which reports its analytic work, where it computes the layer; else
    blockwise), where the JAX dry run lowers blockwise everywhere.  The
    counts do not depend on the mesh and are made once a cell pair;
  * one JSON record a cell under artifacts/dryrun_torch/.

The collective term: the step is counted a second time under a fake
process group of the mesh's size (``torch.distributed``'s "fake" backend
with a ``FakeStore``: rank 0's view, no data moves), on a DeviceMesh with
the production mesh's axis names (the multi-pod mesh as (pod x data,
model): ``counting_mesh``).  The parameters (for train also the
optimizer state), the batch and the caches are DTensors on meta, placed
by the specs (``models.sharding.make_param_shardings``,
``specs.opt_state_shardings``, ``batch_spec_shardings``,
``cache_shardings``); activations are constrained where the model calls
``sharding.constrain``, and the MoE shard-map path issues its own
collectives.  ``launch.collectives.record()`` sums the result bytes of
every collective DTensor's sharding propagation (or the model) issues:
``collectives`` (per-device bytes by kind, as the JAX record's field),
``collective_ops`` (counts) and ``collectives_scaled`` (the same: the
port's step has no loops whose body a trip count would multiply).  This
pass runs attention "naive" (one product a layer; blockwise dispatches
each key block through DTensor, and the flash wrapper takes no
DTensor): the attention's collectives follow q, k and v's placements,
not the route.  ``collective_s`` is each collective's bytes over its
group's link (``link_of``: NVLink inside one HGX node, else the node
network), summed; ``collective_links`` holds the bytes by link.  Where
DTensor has no sharding rule for an op of the step, the cell keeps
``collectives = None`` and ``collective_reason`` names the op.
``dominant`` is taken over the three terms.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh both [--smoke] [--optimized] \\
      [--out artifacts/dryrun_torch]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import re
import time
import traceback

import torch

from repro_torch import configs
from repro_torch.launch import collectives, roofline, serve, specs, train
from repro_torch.launch.mesh import MeshShape, make_production_mesh
from repro_torch.models import lm, sharding as sh, steps
from repro_torch.models.config import active_param_count, param_count
from repro_torch.pytree import tree_map

# NVIDIA H100 SXM data sheet: 80 GB of HBM3 a card, NVLink 4 at 900 GB/s a
# card in all, 450 GB/s each way; the peaks are roofline.py's.
HBM_PER_CHIP = 80e9
NVLINK_BW = 450e9
# NVIDIA DGX H100 / HGX H100: 8 cards a node on NVLink, and the node
# network one ConnectX-7 400 Gb/s (NDR InfiniBand) port a card: 50 GB/s
NODE_CARDS = 8
NETWORK_BW = 50e9
LINK_BW = {"nvlink": NVLINK_BW, "network": NETWORK_BW}


def step_impl(cfg, shape) -> str:
    """The attention route the port's entry point takes for the cell."""
    if shape.kind == "train":
        return train.train_impl(shape.seq_len)
    return serve.prefill_impl(cfg)


def link_of(ranks) -> str:
    """"nvlink" for a group whose ranks all lie in one node (ranks
    NODE_CARDS * n to NODE_CARDS * n + 7, the consecutive placement), else
    "network"."""
    return ("nvlink" if min(ranks) // NODE_CARDS == max(ranks) // NODE_CARDS
            else "network")


def lower_cell(cfg, shape, mesh, impl=None, optimized=False):
    """(step, args, meta) of one cell: the step function, its inputs as
    meta tensors and the per-device state bytes on `mesh`.
    ``meta["_shardings"]`` holds each input's MeshSharding tree (None for
    a replicated scalar), parallel to args."""
    cfg = specs.config_for(cfg, shape, optimized)
    impl = impl or step_impl(cfg, shape)
    rules = specs.rules_for(cfg, shape, optimized)
    axes, pshapes = lm.param_axes(cfg), lm.param_shapes(cfg)
    pshard = sh.make_param_shardings(mesh, rules, axes, pshapes)
    tok = specs.token_specs(cfg, shape)
    meta = {"params_bytes_device": specs.sharded_bytes_per_device(
        pshapes, pshard, mesh)}
    extras = {k: tok[k] for k in ("patches", "frames") if k in tok}
    tshard = specs.batch_spec_shardings(mesh, rules, cfg, shape, tok)

    if shape.kind == "train":
        opt_name, (opt_init, opt_update) = specs.optimizer_for(cfg)
        oshapes = opt_init(pshapes)
        oshard = specs.opt_state_shardings(mesh, rules, opt_name, axes,
                                           pshapes, oshapes)
        meta["opt_bytes_device"] = specs.sharded_bytes_per_device(
            oshapes, oshard, mesh)
        meta["optimizer"] = opt_name
        step = steps.make_train_step(cfg, opt_update, impl=impl)
        meta["_shardings"] = (pshard, oshard, None, tshard)
        return step, (pshapes, oshapes, 0, tok), meta

    cshapes = specs.cache_shapes(cfg, shape.global_batch, shape.seq_len)
    cshard = specs.cache_shardings(mesh, rules, cshapes)
    meta["cache_bytes_device"] = specs.sharded_bytes_per_device(
        cshapes, cshard, mesh)
    if shape.kind == "prefill":
        prefill = steps.make_prefill_step(cfg, impl=impl)

        def step(params, tokens, caches, extras):
            return prefill(params, tokens, caches, **extras)
        ex = {k: tshard[k] for k in extras}
        meta["_shardings"] = (pshard, tshard["tokens"], cshard, ex)
        return step, (pshapes, tok["tokens"], cshapes, extras), meta

    decode = steps.make_decode_step(cfg, impl=impl)
    pos = torch.zeros((), dtype=torch.int32, device="meta")
    meta["_shardings"] = (pshard, cshard, tshard["tokens"], None)
    return decode, (pshapes, cshapes, tok["tokens"], pos), meta


def _local_shape(shape, spec, sizes) -> tuple:
    out = list(shape)
    for d, entry in enumerate(spec):
        for n in sh.spec_names(entry):
            out[d] //= sizes[n]
    return tuple(out)


def placed(tree, shardings, dmesh):
    """The meta tensors of `tree` as DTensors on `dmesh`, each holding its
    local block under its MeshSharding (None leaves `tree` as it is)."""
    from torch.distributed.tensor import DTensor

    if shardings is None:
        return tree
    sizes = sh.mesh_sizes(dmesh)

    def one(s, t):
        local = torch.empty(_local_shape(t.shape, s.spec, sizes),
                            dtype=t.dtype, device="meta")
        return DTensor.from_local(
            local, dmesh, sh.placements_for(dmesh, s.spec), run_check=False,
            shape=t.shape, stride=t.stride())
    return tree_map(one, shardings, tree,
                    is_leaf=lambda x: isinstance(x, sh.MeshSharding))


@contextlib.contextmanager
def fake_world(mesh):
    """A fake process group of ``mesh.size`` ranks (rank 0's view, no data
    moves) and a DeviceMesh over it with `mesh`'s axis names and sizes,
    destroyed on exit."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a fake world needs the default process group: "
                           "one is already running")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh.size)
    try:
        yield init_device_mesh("cpu", tuple(mesh.sizes),
                               mesh_dim_names=tuple(mesh.axis_names))
    finally:
        dist.destroy_process_group()


def unsharded_op(err: BaseException, last_op) -> str:
    """The op an error of DTensor's dispatch names (``aten.x.y``), else the
    op dispatched last, with the error."""
    m = re.search(r"(aten\.[\w.]+|c10d\w*\.[\w.]+)", str(err))
    if m:
        return m.group(1)
    return f"{last_op}: {err!r}"[:300]


def counting_mesh(mesh):
    """The mesh the collectives are counted on: `mesh`, with "pod" and
    "data" merged into one "data" axis (pod-major, so the ranks are the
    same).  The rules take pod and data together for the batch and the
    sequence, so those placements do not change; FSDP (``Rules.fsdp``,
    "data" alone) then shards pod x data ways where the production mesh
    shards data ways and replicates over the pods.  DTensor's sharding
    propagation searches its redistribution graph for every candidate of
    an op on a 3-D mesh, which takes it minutes an op."""
    if "pod" not in mesh.axis_names:
        return mesh
    sizes = mesh.shape
    return MeshShape(("data", "model"),
                     (sizes["pod"] * sizes["data"], sizes["model"]))


def count_collectives(cfg, shape, mesh, optimized=False) -> dict:
    """The cell's collectives, counted on a fake process group of
    ``mesh.size`` ranks (rank 0's view) over a DeviceMesh with `mesh`'s
    axis names and sizes: the step (attention "naive") run once on meta
    DTensors placed by the specs.  Returns the record's collective fields;
    ``collectives`` is None, and ``collective_reason`` names the op,
    where DTensor cannot shard the step."""
    from torch.distributed.tensor.experimental import implicit_replication

    mesh = counting_mesh(mesh)
    rec = collectives.record()
    if mesh.size == 1:
        # one rank exchanges nothing; no fake world starts, so a cell on a
        # 1x1 mesh is also counted beside a running world (on a card)
        return collective_term(rec, mesh)
    step, args, meta = lower_cell(cfg, shape, mesh, impl="naive",
                                  optimized=optimized)
    rules = specs.rules_for(specs.config_for(cfg, shape, optimized), shape,
                            optimized)
    with fake_world(mesh) as dmesh:
        try:
            args = [placed(a, s, dmesh)
                    for a, s in zip(args, meta["_shardings"])]
            sh.set_context(dmesh, rules)
            with implicit_replication(), rec:
                step(*args)
        except Exception as e:        # DTensor has no rule for an op
            return {"collectives": None, "collective_ops": None,
                    "collectives_scaled": None, "collective_links": None,
                    "collective_s": None,
                    "collective_reason": unsharded_op(e, rec.last_op)}
        finally:
            sh.set_context(None)
    return collective_term(rec, mesh)


def collective_term(rec, mesh) -> dict:
    """The record's collective fields from a recorder's counts on
    `mesh`."""
    links = {k: 0 for k in LINK_BW}
    for ranks, b in rec.by_group.items():
        # a collective with no group the recorder could read spans the world
        links[link_of(ranks or range(mesh.size))] += b
    return {"collectives": rec.bytes, "collective_ops": dict(rec.ops),
            "collectives_scaled": rec.bytes, "collective_links": links,
            "collective_s": sum(b / LINK_BW[k] for k, b in links.items()),
            "collective_bw": LINK_BW, "collective_reason": None,
            "collective_mesh": "x".join(map(str, mesh.sizes))}


_COSTS: dict = {}      # (arch, shape, optimized) -> (costs, seconds)


def analyze(step, args, meta, cfg, shape, mesh, key, optimized=False) -> dict:
    """The cell's record from its step's op counts (made once per `key`:
    they do not depend on the mesh), its state bytes and its collectives
    on `mesh`."""
    chips = mesh.size
    rec = {k: v for k, v in meta.items() if not k.startswith("_")}
    rec["mesh"] = "x".join(str(mesh.shape[a]) for a in mesh.axis_names)
    rec["chips"] = chips
    if key not in _COSTS:
        t0 = time.time()
        costs = roofline.op_costs(step, *args)
        _COSTS[key] = (costs, time.time() - t0)
    costs, rec["count_s"] = _COSTS[key]
    rec["flops_global"] = float(costs["flops"])
    rec["bytes_global"] = float(costs["bytes"])
    rec["flops_by_dtype"] = {k: costs[k] for k in (
        "dot_flops_bf16", "dot_flops_f32", "other_flops")}
    rec["kernel_reported_flops"] = costs["reported_flops"]
    rec["kernel_reports"] = costs["reported_calls"]

    state = sum(rec.get(k, 0) for k in (
        "params_bytes_device", "opt_bytes_device", "cache_bytes_device"))
    rec["state_bytes_device"] = state
    rec["fits_hbm_state"] = bool(state < HBM_PER_CHIP)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    n_active = active_param_count(cfg)
    rec["n_params"] = param_count(cfg)
    rec["n_active_params"] = n_active
    mult = 6 if shape.kind == "train" else 2
    rec["model_flops"] = float(mult * n_active * tokens)
    rec["tokens"] = tokens
    # per-step seconds: the global work spread over the chips, each at one
    # H100's peak (f32 products at the f32 rate: TF32 off, the port's
    # default)
    bound = roofline.bound_s(costs, tf32=False)
    rec["tf32"] = False
    rec["compute_s"] = bound["compute_s"] / chips
    rec["memory_s"] = max(costs["bytes"] / chips, state) / roofline.HBM_BW
    t0 = time.time()
    rec.update(count_collectives(cfg, shape, mesh, optimized))
    rec["collective_count_s"] = time.time() - t0
    terms = ("compute_s", "memory_s") + (
        ("collective_s",) if rec["collective_s"] is not None else ())
    rec["dominant"] = max(terms, key=lambda k: rec[k])
    rec["useful_flops_ratio"] = (rec["model_flops"] / rec["flops_global"]
                                 if rec["flops_global"] else 0.0)
    return rec


def run_cell(arch, shape_name, multi_pod, smoke=False,
             out_dir="artifacts/dryrun_torch", optimized=False, mesh=None,
             shape=None):
    """One cell's record, also written to out_dir.  `mesh` (a MeshShape)
    and `shape` (a configs.ShapeSpec) replace the production mesh and
    the named shape (a cell at a launcher's own shape on a card)."""
    cfg = configs.get_config(arch, smoke=smoke)
    shape = shape or configs.SHAPES[shape_name]
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    ok, why = configs.cell_supported(cfg, shape)
    tag = (f"{configs.normalize(arch)}__{shape.name}__"
           + "x".join(map(str, mesh.sizes)))
    outp = pathlib.Path(out_dir)
    outp.mkdir(parents=True, exist_ok=True)
    rec = {"arch": cfg.name, "shape": shape.name, "multi_pod": multi_pod,
           "smoke": smoke, "optimized": optimized}
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        (outp / f"{tag}.json").write_text(json.dumps(rec, indent=1))
        print(f"[dryrun] {tag}: SKIPPED ({why})", flush=True)
        return rec
    t0 = time.time()
    try:
        step, args, meta = lower_cell(cfg, shape, mesh, optimized=optimized)
        t1 = time.time()
        rec["impl"] = step_impl(cfg, shape)
        rec.update(analyze(step, args, meta, cfg, shape, mesh,
                           key=(cfg.name, shape, optimized),
                           optimized=optimized))
        rec["status"] = "ok"
        rec["specs_s"] = t1 - t0
        coll = ("n/a: " + rec["collective_reason"] if rec["collectives"] is None
                else f"{rec['collectives']['total'] / 1e9:.3f} GB")
        print(f"[dryrun] {tag}: OK count={rec['count_s']:.1f}s "
              f"dom={rec['dominant']} flops={rec['flops_global']:.3e} "
              f"collectives/device={coll} "
              f"state/device={rec['state_bytes_device'] / 1e9:.2f} GB",
              flush=True)
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = repr(e)
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[dryrun] {tag}: ERROR {e!r}", flush=True)
    (outp / f"{tag}.json").write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--optimized", action="store_true",
                    help="apply the tuned layouts (specs.OPTIMIZED_RULES)")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)

    archs = configs.ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(configs.SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    n_ok = n_skip = n_err = 0
    for arch in archs:
        for shp in shapes:
            for mp in meshes:
                rec = run_cell(arch, shp, mp, smoke=args.smoke,
                               out_dir=args.out, optimized=args.optimized)
                n_ok += rec["status"] == "ok"
                n_skip += rec["status"] == "skipped"
                n_err += rec["status"] == "error"
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_err} errors",
          flush=True)
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
