"""Optimizers on torch (the port of repro.optim.optimizers): AdamW and
Adafactor, with the JAX package's arithmetic, not torch.optim's.

API: make_optimizer(name, ...) -> (init_fn, update_fn)
  init_fn(params) -> opt_state
  update_fn(grads, opt_state, params, step) -> (updates, new_state)
(updates are ADDED to params by the caller.)

Trees are nested dicts and lists of tensors (repro_torch.pytree).  What
must match the JAX package and why:

  * the schedule and AdamW's bias corrections are f32 tensors, as JAX's
    ``jnp.asarray(step, jnp.float32)`` makes them (Python floats would
    carry them in double and move the bias correction by about 1e-7);
  * AdamW's update is computed in f32 and cast to the parameter's dtype
    before the caller adds it, so bf16 parameters round twice, as in the
    JAX package (torch.optim.AdamW adds in one rounding);
  * Adafactor factors a tensor's second moment when its last two dims
    are both at least ``min_dim_factored``, and scales by ``rsqrt``.

Both update functions are functional: nothing they are given is written.
"""

from __future__ import annotations

import math

import torch

from repro_torch.pytree import tree_leaves, tree_map


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """lr(step) -> f32 0-d tensor: linear warmup over `warmup` steps,
    then a cosine from base_lr to 0 at `total`.  step: an int or an
    integer tensor (the result lies on its device)."""
    def lr(step):
        dev = step.device if isinstance(step, torch.Tensor) else None
        s = _f32(step, dev)
        warm = s / max(1.0, warmup)
        prog = torch.clamp((s - warmup) / max(1.0, total - warmup), 0, 1)
        cos = 0.5 * (1 + torch.cos(math.pi * prog))
        return base_lr * torch.where(s < warmup, warm, cos)
    return lr


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled so their global norm is at most max_norm, each in its
    own dtype; the global norm before clipping, f32)."""
    leaves = tree_leaves(grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def _unzip(out, n: int) -> list:
    """A tree of n-tuples -> n trees."""
    is_tuple = lambda x: isinstance(x, tuple)
    return [tree_map(lambda o: o[i], out, is_leaf=is_tuple) for i in range(n)]


def adamw(lr_fn, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
          state_dtype=torch.float32):
    def init(params):
        z = lambda p: torch.zeros(p.shape, dtype=state_dtype, device=p.device)
        return {"m": tree_map(z, params), "v": tree_map(z, params)}

    def update(grads, state, params, step):
        dev = tree_leaves(params)[0].device
        lr = lr_fn(_f32(step, dev))
        t = _f32(step, dev) + 1.0
        bc1 = 1 - b1 ** t
        bc2 = 1 - b2 ** t

        def upd(g, m, v, p):
            gf = g.float()
            m2 = b1 * m.float() + (1 - b1) * gf
            v2 = b2 * v.float() + (1 - b2) * gf * gf
            u = -lr * ((m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
                       + weight_decay * p.float())
            return u.to(p.dtype), m2.to(state_dtype), v2.to(state_dtype)

        updates, m, v = _unzip(
            tree_map(upd, grads, state["m"], state["v"], params), 3)
        return updates, {"m": m, "v": v}

    return init, update


def adafactor(lr_fn, decay=0.99, eps=1e-30, clip_threshold=1.0,
              min_dim_factored: int = 128):
    """Factored second-moment optimizer [Shazeer & Stern '18].  Tensors
    with >= 2 dims both >= min_dim_factored store row/col statistics only
    — O(n+m) instead of O(n*m) state."""

    def _factored(p):
        return p.dim() >= 2 and p.shape[-1] >= min_dim_factored \
            and p.shape[-2] >= min_dim_factored

    def init(params):
        def z(p):
            zeros = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                              device=p.device)
            if _factored(p):
                return {"vr": zeros(p.shape[:-1]),
                        "vc": zeros(p.shape[:-2] + p.shape[-1:])}
            return {"v": zeros(p.shape)}
        return {"stats": tree_map(z, params)}

    def update(grads, state, params, step):
        lr = lr_fn(_f32(step, tree_leaves(params)[0].device))

        def upd(g, st, p):
            gf = g.float()
            g2 = gf * gf + eps
            if "vr" in st:
                vr = decay * st["vr"] + (1 - decay) * g2.mean(-1)
                vc = decay * st["vc"] + (1 - decay) * g2.mean(-2)
                denom = torch.clamp(vr.mean(-1, keepdim=True), min=eps)
                vhat = (vr[..., None] / denom[..., None]) * vc[..., None, :]
                u = gf * torch.rsqrt(vhat + eps)
                new = {"vr": vr, "vc": vc}
            else:
                v = decay * st["v"] + (1 - decay) * g2
                u = gf * torch.rsqrt(v + eps)
                new = {"v": v}
            rms = torch.sqrt(torch.mean(u * u) + 1e-12)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            return (-lr * u).to(p.dtype), new

        is_stat = lambda x: isinstance(x, dict) and ("v" in x or "vr" in x)
        # the stats tree is walked first: its per-leaf dicts are its leaves
        out = tree_map(lambda st, g, p: upd(g, st, p), state["stats"], grads,
                       params, is_leaf=is_stat)
        updates, stats = _unzip(out, 2)
        return updates, {"stats": stats}

    return init, update


def make_optimizer(name: str, lr: float = 3e-4, warmup: int = 100,
                   total: int = 10_000, **kw):
    lr_fn = cosine_schedule(lr, warmup, total)
    if name == "adamw":
        return adamw(lr_fn, **kw)
    if name == "adafactor":
        return adafactor(lr_fn, **kw)
    raise ValueError(name)
