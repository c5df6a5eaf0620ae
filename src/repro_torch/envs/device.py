"""Capability probes for device-evaluable environment / simulation twins.

The port of the probe half of repro.envs.device.  The fused K-superstep
dispatch keeps select -> insert -> simulate -> finalize -> backup on the
device for K supersteps; that needs environments and simulation backends
with device twins that are bit-identical to their host halves (duck-typed
protocol):

  env.step_device(states, actions) -> (next_states, terminal)
  env.num_actions_device(states) -> int32[B]
  env.resolvable_device(states, actions) -> bool[B]   (optional)
  sim.evaluate_device(states) -> f32[B]

The serving pools and the scheduler probe backends with these functions.
The twins themselves (``hash24_device``, rebuilt on int64 with explicit
masks since torch has no uint32 arithmetic, and the ``*_device`` methods
of envs.bandit_tree) come with the fused dispatch, ROADMAP.md queue A
item 3.  Nothing here imports a kernel.
"""

from __future__ import annotations

import numpy as np
import torch


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
