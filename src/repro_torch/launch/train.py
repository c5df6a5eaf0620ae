"""Training launcher on torch (the port of repro.launch.train).

Config-driven arch selection, the deterministic data pipeline with host
prefetch, gradient-accumulation microbatching, atomic and async
checkpointing with restart-replay, optional int8 gradient compression.
Attention runs "naive" up to 512 tokens and "blockwise" beyond, as in
the JAX launcher (the flash kernel has no backward).  whisper gets stub
frame embeddings and paligemma stub patch embeddings (zeros), as there.
Runs on the CUDA card unless given --device cpu; returns the logged
losses.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --steps 20 --batch 8 --seq 512
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --smoke --steps 200 --batch 8 --seq 128 --ckpt /tmp/ckpt --device cpu
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
from repro_torch.core.tree import resolve_device
from repro_torch.data import Prefetcher, SyntheticTokens
from repro_torch.distributed import CheckpointManager
from repro_torch.launch import specs
from repro_torch.models import lm, param_count, steps
from repro_torch.optim.compression import int8_roundtrip


def train_impl(seq: int) -> str:
    """The launcher's attention route for a sequence length."""
    return "naive" if seq <= 512 else "blockwise"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress", action="store_true",
                    help="int8 gradient compression (inter-pod trick)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises without a card); cpu runs "
                         "the plain torch path")
    return ap.parse_args(argv)


def main(argv=None, device=None):
    """Train --arch with the flags in argv; `device` (a caller's, e.g.
    "cpu") overrides --device.  Returns the logged losses."""
    args = parse_args(argv)
    return train(configs.get_config(args.arch, smoke=args.smoke), args,
                 device=args.device if device is None else device)


def train(cfg, args, device=None):
    """The launcher's loop over `cfg` (main() looks it up from --arch;
    a caller may pass a cut config) with parse_args' flags; returns the
    logged losses."""
    device = resolve_device(device)
    print(f"[train] {cfg.name}: {param_count(cfg):,} params on {device}")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = lm.init_params(cfg, gen, device)
    _, (opt_init, opt_update) = specs.optimizer_for(cfg)
    opt_state = opt_init(params)
    train_step = steps.make_train_step(
        cfg, opt_update, microbatches=args.microbatches,
        compress_fn=int8_roundtrip if args.compress else None,
        impl=train_impl(args.seq))

    start = 0
    mgr = None
    if args.ckpt:
        mgr = CheckpointManager(args.ckpt, keep_last=3, async_save=True)
        s, state, _ = mgr.restore_latest({"params": params, "opt": opt_state})
        if s is not None:
            start = s + 1
            params, opt_state = state["params"], state["opt"]
            print(f"[train] resumed from step {s}")

    src = SyntheticTokens(cfg.vocab, args.batch, args.seq, seed=args.seed)
    pf = Prefetcher(src, start_step=start)
    losses = []
    t0 = time.time()
    try:
        for _ in range(start, args.steps):
            step_i, batch = pf.next()
            batch = {k: torch.as_tensor(v, device=device)
                     for k, v in batch.items()}
            if cfg.vlm_patches:
                batch["patches"] = torch.zeros(
                    (args.batch, cfg.vlm_patches, cfg.d_model), device=device)
            if cfg.encoder is not None:
                batch["frames"] = torch.zeros(
                    (args.batch, cfg.encoder.n_frames, cfg.d_model),
                    device=device)
            params, opt_state, metrics = train_step(
                params, opt_state, step_i, batch)
            if step_i % args.log_every == 0 or step_i == args.steps - 1:
                loss = float(metrics["loss"])
                losses.append(loss)
                dt_ = time.time() - t0
                tok_s = (step_i - start + 1) * args.batch * args.seq / max(dt_, 1e-9)
                print(f"[train] step {step_i:5d} loss {loss:8.4f} "
                      f"gnorm {float(metrics['grad_norm']):7.3f} "
                      f"tok/s {tok_s:9.0f}", flush=True)
            if mgr and step_i and step_i % args.ckpt_every == 0:
                mgr.save(step_i, {"params": params, "opt": opt_state})
        if mgr:
            mgr.save(args.steps - 1, {"params": params, "opt": opt_state})
            mgr.wait()
    finally:
        pf.close()
    print(f"[train] done: first loss {losses[0]:.4f} -> last {losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
