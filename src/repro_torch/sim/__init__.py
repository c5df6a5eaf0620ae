"""repro_torch.sim — the simulation serving subsystem of the port
(mirrors repro.sim).

SimServer microbatches every caller's rows behind one fixed-shape forward
(priority-classed admission window, fixed-shape padding, non-blocking
submit/collect), SimCache/CachedSimBackend short-circuit re-expanded
positions, and sim.lm serves LM-decode-as-tree-search through the
continuous batcher.

Wire any of them in with ``SearchClient(env, sim_backend=...)``.

LM pieces (LMTreeEnv, LMContinuationBackend) are imported lazily — they
pull in the model stack, which non-LM serving paths never need.
"""

from repro_torch.sim.cache import CachedSimBackend, SimCache
from repro_torch.sim.server import PRIORITY_CLASSES, PendingBatch, SimServer

__all__ = [
    "CachedSimBackend", "LMContinuationBackend", "LMTreeEnv",
    "PRIORITY_CLASSES", "PendingBatch", "SimCache", "SimServer",
]

_LM_NAMES = ("LMTreeEnv", "LMContinuationBackend", "MAXLEN")


def __getattr__(name):
    if name in _LM_NAMES:
        from repro_torch.sim import lm

        return getattr(lm, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
