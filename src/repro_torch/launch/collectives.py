"""Collective traffic of the port's distributed code (the counterpart of
repro.launch.collectives).

The JAX package parses compiled, post-SPMD HLO text for the result bytes
of every all-gather / all-reduce / reduce-scatter / all-to-all.  The port
runs eagerly and has no HLO, so nothing is parsed: ``record()`` is a
context manager that sees every collective op dispatched while it is
open (``torch.distributed``'s ``c10d`` ops and the functional
collectives ``_c10d_functional`` that DTensor redistributions issue,
through a ``TorchDispatchMode``) and sums their **result bytes** by kind,
the quantity the JAX parser counts.  Eager execution issues a collective
each time it runs, so the JAX roofline's loop trip-count scaling of HLO
while bodies (``scaled_collectives``, ``_split_computations``) has no
counterpart here.

    with collectives.record() as rec:
        dist.all_reduce(t, group=g)
    rec.bytes   # {"all_reduce": t.nbytes, ..., "total": ...}
"""

from __future__ import annotations

from collections import defaultdict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

KINDS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
         "broadcast")

# op name (namespace stripped) -> kind.  c10d's ops write their first
# argument in place (the result); the functional ops return it.
_C10D = {"allreduce_": "all_reduce", "allreduce_coalesced_": "all_reduce",
         "allgather_": "all_gather", "_allgather_base_": "all_gather",
         "allgather_into_tensor_coalesced_": "all_gather",
         "reduce_scatter_": "reduce_scatter",
         "_reduce_scatter_base_": "reduce_scatter",
         "reduce_scatter_tensor_coalesced_": "reduce_scatter",
         "alltoall_": "all_to_all", "alltoall_base_": "all_to_all",
         "broadcast_": "broadcast"}
_FUNCTIONAL = {"all_reduce": "all_reduce", "all_reduce_": "all_reduce",
               "all_reduce_coalesced": "all_reduce",
               "all_gather_into_tensor": "all_gather",
               "all_gather_into_tensor_coalesced": "all_gather",
               "reduce_scatter_tensor": "reduce_scatter",
               "reduce_scatter_tensor_coalesced": "reduce_scatter",
               "all_to_all_single": "all_to_all", "broadcast": "broadcast",
               "broadcast_": "broadcast"}


def tensor_bytes(x) -> int:
    """Bytes of the tensors in x (a tensor or nested lists of them)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(tensor_bytes(e) for e in x)
    return 0


def kind_of(func) -> tuple:
    """(kind, True where the result is the op's first argument) of a
    dispatched op, or (None, False) for a non-collective."""
    ns, name = func.namespace, func._schema.name.split("::")[-1]
    if ns == "c10d" and name in _C10D:
        return _C10D[name], True
    if ns == "_c10d_functional" and name in _FUNCTIONAL:
        return _FUNCTIONAL[name], False
    return None, False


def group_ranks(func, args, kwargs) -> tuple:
    """The global ranks of the group a collective runs over (its
    ``group_name`` or ``process_group`` argument), or () where none can be
    read."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    names = [a.name for a in func._schema.arguments]
    for key in ("group_name", "process_group"):
        if key not in names:
            continue
        i = names.index(key)
        g = kwargs.get(key, args[i] if i < len(args) else None)
        try:
            if isinstance(g, str):
                g = _resolve_process_group(g)
            return tuple(dist.get_process_group_ranks(g))
        except (RuntimeError, ValueError, TypeError, AttributeError):
            return ()
    return ()


class record(TorchDispatchMode):
    """Sums the result bytes of the collectives dispatched inside the
    block, by kind: ``bytes`` {kind: bytes, "total": bytes}, ``ops``
    {kind: count}, ``by_group`` {the group's global ranks: bytes} and
    ``calls`` [(kind, result shape, bytes)] in the order they ran.
    Collectives that DTensor issues for a redistribution are seen too."""

    def __init__(self):
        super().__init__()
        self._bytes = defaultdict(int)
        self.ops = defaultdict(int)
        self.by_group = defaultdict(int)
        self.last_op = None          # the op dispatched last (errors name it)
        self.calls = []              # (kind, result shape, bytes) in order

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **(kwargs or {}))
        self.last_op = func
        if any(issubclass(t, DTensor) for t in types):
            # a mode runs before a tensor subclass: hand the op to DTensor,
            # whose sharding propagation desugars it into local ops and
            # the collectives its placements need, which come back here
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        kind, in_place = kind_of(func)
        if kind is not None:
            res = args[0] if in_place else out
            n = tensor_bytes(res)
            self._bytes[kind] += n
            self.ops[kind] += 1
            self.by_group[group_ranks(func, args, kwargs or {})] += n
            shape = tuple(res.shape) if isinstance(res, torch.Tensor) else None
            self.calls.append((kind, shape, n))
        return out

    @property
    def bytes(self) -> dict:
        out = {k: self._bytes.get(k, 0) for k in KINDS}
        out["total"] = sum(out.values())
        return out
