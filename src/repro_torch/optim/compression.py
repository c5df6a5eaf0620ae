"""Gradient compression on torch (the port of repro.optim.compression):
int8 quantization with a per-tensor scale, and top-k sparsification
with error feedback (the caller keeps the residual).  Pure functions; on
one card they model the numerics of what would cross a slow link
(``make_train_step(compress_fn=int8_roundtrip)``).

``torch.round`` rounds half to even, as ``jnp.round`` does.
"""

from __future__ import annotations

import torch

from repro_torch.pytree import tree_map


def compress_int8(g):
    """[-max|g|, max|g|] -> int8 with per-tensor scale (f32 0-d)."""
    gf = g.float()
    scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q, scale, dtype=torch.float32):
    return (q.float() * scale).to(dtype)


def int8_roundtrip(grads):
    """Grad transform used by make_train_step(compress_fn=...)."""
    def one(g):
        q, s = compress_int8(g)
        return decompress_int8(q, s, g.dtype)
    return tree_map(one, grads)


def topk_sparsify(g, frac: float = 0.01):
    """Keep the top `frac` fraction of entries by magnitude; returns
    (sparse_g, residual) for error feedback."""
    gf = g.float()
    flat = gf.reshape(-1)
    k = max(1, int(flat.shape[0] * frac))
    thresh = torch.topk(flat.abs(), k).values[-1]
    keep = gf.abs() >= thresh
    sparse = torch.where(keep, gf, 0.0)
    return sparse.to(g.dtype), (gf - sparse).to(g.dtype)
