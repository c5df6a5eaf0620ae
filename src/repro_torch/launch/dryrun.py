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

The JAX dry run lowers and compiles each cell for 512 host devices and
reads XLA's memory and cost analyses and the post-SPMD HLO.  The port has
no SPMD partitioner: the step is not run sharded, so there is no
per-device program to read and no collective to count.  ``collectives``
and ``collective_s`` are null in every record, with the reason, and
``dominant`` is taken over the two terms there are.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh both [--smoke] [--optimized] \\
      [--out artifacts/dryrun_torch]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time
import traceback

import torch

from repro_torch import configs
from repro_torch.launch import roofline, serve, specs, train
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import lm, sharding as sh, steps
from repro_torch.models.config import active_param_count, param_count

# NVIDIA H100 SXM data sheet: 80 GB of HBM3 a card, NVLink 4 at 900 GB/s a
# card in all, 450 GB/s each way; the peaks are roofline.py's.
HBM_PER_CHIP = 80e9
NVLINK_BW = 450e9
NO_COLLECTIVES = ("no SPMD partitioner in the port: the step is not run "
                  "sharded")


def step_impl(cfg, shape) -> str:
    """The attention route the port's entry point takes for the cell."""
    if shape.kind == "train":
        return train.train_impl(shape.seq_len)
    return serve.prefill_impl(cfg)


def lower_cell(cfg, shape, mesh, impl=None, optimized=False):
    """(step, args, meta) of one cell: the step function, its inputs as
    meta tensors and the per-device state bytes on `mesh`."""
    cfg = specs.config_for(cfg, shape, optimized)
    impl = impl or step_impl(cfg, shape)
    rules = specs.rules_for(cfg, shape, optimized)
    axes, pshapes = lm.param_axes(cfg), lm.param_shapes(cfg)
    pshard = sh.make_param_shardings(mesh, rules, axes, pshapes)
    tok = specs.token_specs(cfg, shape)
    meta = {"params_bytes_device": specs.sharded_bytes_per_device(
        pshapes, pshard, mesh)}
    extras = {k: tok[k] for k in ("patches", "frames") if k in tok}

    if shape.kind == "train":
        opt_name, (opt_init, opt_update) = specs.optimizer_for(cfg)
        oshapes = opt_init(pshapes)
        oshard = specs.opt_state_shardings(mesh, rules, opt_name, axes,
                                           pshapes, oshapes)
        meta["opt_bytes_device"] = specs.sharded_bytes_per_device(
            oshapes, oshard, mesh)
        meta["optimizer"] = opt_name
        step = steps.make_train_step(cfg, opt_update, impl=impl)
        return step, (pshapes, oshapes, 0, tok), meta

    cshapes = specs.cache_shapes(cfg, shape.global_batch, shape.seq_len)
    cshard = specs.cache_shardings(mesh, rules, cshapes)
    meta["cache_bytes_device"] = specs.sharded_bytes_per_device(
        cshapes, cshard, mesh)
    if shape.kind == "prefill":
        prefill = steps.make_prefill_step(cfg, impl=impl)

        def step(params, tokens, caches):
            return prefill(params, tokens, caches, **extras)
        return step, (pshapes, tok["tokens"], cshapes), meta

    decode = steps.make_decode_step(cfg, impl=impl)
    pos = torch.zeros((), dtype=torch.int32, device="meta")
    return decode, (pshapes, cshapes, tok["tokens"], pos), meta


_COSTS: dict = {}      # (arch, shape, optimized) -> (costs, seconds)


def analyze(step, args, meta, cfg, shape, mesh, key) -> dict:
    """The cell's record from its step's op counts (made once per `key`:
    they do not depend on the mesh) and its state bytes."""
    chips = mesh.size
    rec = dict(meta)
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
    rec["collectives"] = None
    rec["collective_s"] = None
    rec["collective_reason"] = NO_COLLECTIVES
    rec["dominant"] = max(("compute_s", "memory_s"), key=lambda k: rec[k])
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
                           key=(cfg.name, shape, optimized)))
        rec["status"] = "ok"
        rec["specs_s"] = t1 - t0
        print(f"[dryrun] {tag}: OK count={rec['count_s']:.1f}s "
              f"dom={rec['dominant']} flops={rec['flops_global']:.3e} "
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
