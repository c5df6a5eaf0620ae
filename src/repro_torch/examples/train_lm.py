"""End-to-end driver: train a ~100M-parameter llama-family model for a few
hundred steps on the synthetic pipeline, with checkpointing and resume
(the port of examples/train_lm.py).

A purpose-built ~100M config (f32, tied embeddings) — deliverable (b)'s
"train ~100M model for a few hundred steps" driver — through the port's
train step (torch.autograd, blockwise attention: the flash kernel has no
backward), AdamW, the host-prefetched synthetic token stream and the
async CheckpointManager.  The learning-rate schedule spans --steps (a
warmup of 20, then a cosine to 0), so a run resumed with another --steps
than it was saved under continues on another schedule.

  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200
"""

import argparse
import os
import tempfile

import torch

from repro_torch.core.tree import resolve_device
from repro_torch.data import Prefetcher, SyntheticTokens
from repro_torch.distributed import CheckpointManager
from repro_torch.examples import device_flag
from repro_torch.models import lm, steps as msteps
from repro_torch.models.config import LayerSpec, ModelConfig, param_count
from repro_torch.optim import make_optimizer

CFG_100M = ModelConfig(
    name="repro-100m",
    d_model=640, n_heads=10, n_kv_heads=5, head_dim=64,
    d_ff=2560, vocab=32000,
    groups=(((LayerSpec(),), 12),),
    tie_embeddings=True, dtype="float32",
)


def run(cfg, steps, batch, seq, ckpt, device="cuda", params=None) -> dict:
    """Train `cfg` for `steps` steps of [batch, seq] tokens, saving to and
    resuming from `ckpt`; `params` (default: drawn from seed 0 on
    `device`) are the initial weights.  Returns {step: loss} of the steps
    this call ran."""
    device = resolve_device(device)
    print(f"[100m] params: {param_count(cfg):,}")
    if params is None:
        params = lm.init_params(
            cfg, torch.Generator(device=device).manual_seed(0), device)
    init, update = make_optimizer("adamw", lr=3e-4, warmup=20, total=steps)
    opt = init(params)
    train = msteps.make_train_step(cfg, update, impl="blockwise")

    mgr = CheckpointManager(ckpt, keep_last=2, async_save=True)
    start = 0
    s, state, _ = mgr.restore_latest({"params": params, "opt": opt})
    if s is not None:
        start, params, opt = s + 1, state["params"], state["opt"]
        print(f"[100m] resumed at {start}")

    src = SyntheticTokens(cfg.vocab, batch, seq, seed=0)
    pf = Prefetcher(src, start_step=start)
    losses = {}
    try:
        for _ in range(start, steps):
            i, b = pf.next()
            b = {k: torch.as_tensor(v, device=device) for k, v in b.items()}
            params, opt, m = train(params, opt, i, b)
            losses[i] = m["loss"]      # read at a log line or the end
            if i % 10 == 0 or i == steps - 1:
                print(f"[100m] step {i:4d} loss {float(m['loss']):.4f}",
                      flush=True)
            if i and i % 50 == 0:
                mgr.save(i, {"params": params, "opt": opt})
        mgr.save(steps - 1, {"params": params, "opt": opt})
        mgr.wait()
    finally:
        pf.close()
    print("[100m] done")
    return {i: float(v) for i, v in losses.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_100m_ckpt"))
    device_flag(ap)
    args = ap.parse_args(argv)
    return run(CFG_100M, args.steps, args.batch, args.seq, args.ckpt,
               args.device)


if __name__ == "__main__":
    main()
