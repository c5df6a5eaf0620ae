"""Device-evaluable environment / simulation twins (the port of
repro.envs.device).

The fused K-superstep dispatch (core.fused) keeps select -> insert ->
simulate -> finalize -> backup on the device for K supersteps; that needs
environments and simulation backends with device twins that are
bit-identical to their host halves (duck-typed protocol):

  env.step_device(states, actions) -> (next_states, terminal)
      Total function over [B, *state_shape] f32 states and [B] integer
      actions (callers pass clamped actions for masked-off rows and
      discard those rows).  No rewards: they are consumed at move
      commits, which always run on the host.
  env.num_actions_device(states) -> int32[B]
  env.resolvable_device(states, actions) -> bool[B]   (optional)
      False rows force the fused dispatch to escape to the host
      expansion path; absent means "always resolvable".
  sim.evaluate_device(states) -> f32[B]
      Values only: prior-producing backends keep the host path.

Every twin is a sequence of eager torch ops on the states' device, with no
host read, so it can run inside a captured CUDA graph.  The one nontrivial
piece is the 64-bit splitmix hash of envs.bandit_tree: torch has no uint64
(nor uint32) arithmetic, so ``hash24_device`` runs it on int64, whose adds
and multiplies wrap mod 2^64 on the CPU and on CUDA exactly as uint64's
do.  Nothing here imports a kernel.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK24 = 0xFFFFFF


def _i64(c: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


# the splitmix64 constants of envs.bandit_tree._hash, as int64
_C1 = _i64(0x9E3779B97F4A7C15)
_C2 = _i64(0xBF58476D1CE4E5B9)


def hash24_device(h: torch.Tensor, a) -> torch.Tensor:
    """Bit-exact device twin of envs.bandit_tree._hash / _hash_batch.

    ``h`` holds 24-bit hashes and ``a`` small action codes (a tensor
    broadcast against h, or a Python int).  Returns the int32 24-bit
    hash, element for element the numpy uint64 result.

    On int64 the add and the multiply wrap mod 2^64 and keep the bits of
    the uint64 result.  The one signed difference is the shift: ``>>`` on
    a negative int64 fills with ones where uint64 fills with zeros.  Only
    bits 0-23 of ``x ^ (x >> 31)`` are kept, and those bits of ``x >> 31``
    are bits 31-54 of x under either shift (the fill reaches bit 33 and
    up), so the result is the same."""
    h = h.to(torch.int64)
    a = a.to(torch.int64) if isinstance(a, torch.Tensor) else int(a)
    x = h ^ (a + _C1 + (h << 6))
    x = x * _C2
    x = x ^ (x >> 31)
    return (x & _MASK24).to(torch.int32)


def has_device_env(env) -> bool:
    """True when the env can resolve expansions inside a fused dispatch."""
    return (callable(getattr(env, "step_device", None))
            and callable(getattr(env, "num_actions_device", None)))


def has_device_sim(sim) -> bool:
    """True when the backend has a device value leg (values only —
    prior-producing backends keep the host path)."""
    return callable(getattr(sim, "evaluate_device", None))


def has_async_sim(sim) -> bool:
    """True when the backend exposes the non-blocking submit/collect
    split: submit enqueues rows into the serving admission window and
    returns a ticket; collect redeems it.  Callers holding several pools'
    rows submit them ALL before collecting, so a microbatching server
    coalesces across pools even when cross-pool fusion is off."""
    return (callable(getattr(sim, "submit", None))
            and callable(getattr(sim, "collect", None)))


def resolvable_device(env, states, actions):
    """bool[B] on the actions' device — rows whose transition the device
    twin can resolve.  Envs without the hook are fully resolvable."""
    hook = getattr(env, "resolvable_device", None)
    if hook is None:
        device = actions.device if isinstance(actions, torch.Tensor) else "cpu"
        return torch.ones(np.shape(actions), dtype=torch.bool, device=device)
    return hook(states, actions)
