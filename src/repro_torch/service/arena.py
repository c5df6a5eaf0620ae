"""Deprecated tree-arena executor shim (use repro_torch.core.executor).

The port of repro.service.arena: the old service-layer executor names
resolve lazily (PEP 562) with a one-time DeprecationWarning, so legacy
imports keep working without charging every ``import
repro_torch.service`` a warning.  The port's names stand where the JAX
package's do: TorchArenaExecutor for JaxArenaExecutor, CudaArenaExecutor
for PallasArenaExecutor.
"""

from __future__ import annotations

import warnings

from repro_torch.core import executor as _executor
from repro_torch.core.tree import TreeConfig

__all__ = [
    "InTreeExecutor", "TorchArenaExecutor", "CudaArenaExecutor",
    "ReferenceArenaExecutor", "make_arena_executor", "make_intree_executor",
]

_ALIASES = {
    "InTreeExecutor": "InTreeExecutor",
    "TorchArenaExecutor": "TorchExecutor",
    "CudaArenaExecutor": "CudaExecutor",
    "ReferenceArenaExecutor": "ReferenceExecutor",
    "make_intree_executor": "make_intree_executor",
}

_warned = False


def _warn_once():
    global _warned
    if not _warned:
        _warned = True
        warnings.warn(
            "repro_torch.service.arena is deprecated: import executors from "
            "repro_torch.core.executor (and serve through "
            "repro_torch.service.client.SearchClient)",
            DeprecationWarning, stacklevel=3)


def _make_arena_executor(cfg: TreeConfig, G: int, name: str, device=None):
    return _executor.make_intree_executor(cfg, G, name, device=device)


def __getattr__(name: str):
    if name == "make_arena_executor":
        _warn_once()
        return _make_arena_executor
    if name in _ALIASES:
        _warn_once()
        return getattr(_executor, _ALIASES[name])
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
