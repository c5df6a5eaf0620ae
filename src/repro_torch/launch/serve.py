"""Serving launcher: batched LM inference = the paper's Simulation backend
(the port of repro.launch.serve).

Stands up an LM (smoke or full config, random weights from --seed),
prefills a batch of prompts, then serves decode steps, reporting the
paper's system-throughput metric (simulation requests per second, one
request = one batched-decode slot).  The prefill runs the flash kernel
where the kernel computes the model's attention, and blockwise where it
does not (``prefill_impl``): MLA archs, whose q/k and v head dims
differ, and a VLM prefix, which the kernel cannot mask.  Whisper's
encoder and cross-attention run the kernel non-causally.  As the JAX
launcher does, whisper gets stub frame embeddings and paligemma stub
patch embeddings (zeros unless the caller passes its own).  Runs on the
CUDA card unless given --device cpu.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --batch 16 --prefill 2048 --tokens 64
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.tree import resolve_device
from repro_torch.models import lm, steps


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prefill_impl(cfg) -> str:
    """The serve prefill's attention route: "flash" unless the kernel
    cannot compute the function (MLA's two head dims, a VLM prefix's
    bidirectional block), then "blockwise"."""
    return "blockwise" if cfg.attn_impl == "mla" or cfg.vlm_patches else "flash"


def cache_len(cfg, prefill: int, tokens: int) -> int:
    """Decode cache slots: the prompt, the new tokens and 8 spare, plus a
    VLM prefix's P patch positions, which the prefill writes first.  (The
    JAX launcher leaves P out, src/repro/launch/serve.py:40: a full
    attention layer's cache is a ring, so with P > 8 decode overwrites
    the patch keys and never sees the image again.)"""
    return cfg.vlm_patches + prefill + tokens + 8


def serve(cfg, batch: int = 16, prefill: int = 64, tokens: int = 64,
          seed: int = 0, device=None, frames=None, patches=None) -> dict:
    """Stand up `cfg` with random weights from `seed`, prefill `batch`
    prompts of `prefill` tokens (by ``prefill_impl(cfg)``), then decode
    `tokens` greedy steps; returns the timings, the device, the route,
    the peak device memory (on a card) and the tokens.  frames [batch,
    n_frames, d] (whisper) and patches [batch, vlm_patches, d]
    (paligemma) default to zeros, as in the JAX launcher."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = lm.init_params(cfg, gen, device)
    impl = prefill_impl(cfg)
    prefill_step = steps.make_prefill_step(cfg, impl=impl)
    decode = steps.make_decode_step(cfg, impl=impl)

    caches = lm.init_caches(cfg, batch, cache_len(cfg, prefill, tokens), device)
    prompts = torch.as_tensor(np.random.RandomState(seed).randint(
        0, cfg.vocab, (batch, prefill)), device=device)
    inputs = {}
    if cfg.vlm_patches:
        inputs["patches"] = (torch.zeros((batch, cfg.vlm_patches, cfg.d_model),
                                         device=device)
                             if patches is None else patches.to(device))
    if cfg.encoder is not None:
        inputs["frames"] = (torch.zeros((batch, cfg.encoder.n_frames,
                                         cfg.d_model), device=device)
                            if frames is None else frames.to(device))

    _sync(device)
    if device.type == "cuda":   # the peak over prefill and decode
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    logits, caches = prefill_step(params, prompts, caches, **inputs)
    _sync(device)
    t1 = time.perf_counter()

    tok = torch.argmax(logits, -1)[:, None]
    out = [tok]
    positions = torch.arange(prefill, prefill + tokens, device=device)
    for i in range(tokens):
        logits, caches = decode(params, caches, tok, positions[i])
        tok = torch.argmax(logits, -1)[:, None]
        out.append(tok)
    _sync(device)
    t2 = time.perf_counter()

    n_req = batch * tokens
    cuda = device.type == "cuda"
    name = torch.cuda.get_device_name(device) if cuda else "cpu"
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    prefix = f"{cfg.vlm_patches}+" if cfg.vlm_patches else ""
    print(f"[serve] {cfg.name}: prefill {batch}x{prefix}{prefill} ({impl}) in "
          f"{t1-t0:.3f}s; {n_req} decode requests in {t2-t1:.3f}s "
          f"=> {n_req/(t2-t1):,.0f} req/s on {name}"
          + (f"; peak {peak / 2**30:.2f} GiB" if cuda else ""), flush=True)
    return {"device": name, "prefill_impl": impl, "prefill_s": t1 - t0,
            "decode_s": t2 - t1, "req_per_s": n_req / (t2 - t1),
            "peak_bytes": peak, "tokens": torch.cat(out, 1).cpu().numpy()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--prefill", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises without a card); cpu runs "
                         "the plain torch path")
    args = ap.parse_args(argv)
    return serve(configs.get_config(args.arch, smoke=args.smoke),
                 batch=args.batch, prefill=args.prefill, tokens=args.tokens,
                 seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
