"""Operation and byte counts of a step, for the roofline (the counterpart
of repro.launch.roofline's ``jaxpr_costs``).

``op_costs(fn, *args, **kw)`` runs fn under a ``TorchDispatchMode`` and
counts every op torch dispatches, by the JAX walker's rules:

  * FLOPs: ``2 * batch * m * n * k`` for every matrix product (``mm``,
    ``bmm``, ``addmm``, ``baddbmm``, ...; the bias add of ``addmm`` counts
    as an elementwise op, as JAX's separate add does), ``2 * out_elems *
    prod(weight.shape[1:])`` for a convolution (torch's OIHW weight: the
    JAX rule's ``prod(rhs.shape[:-1])`` over HWIO), and 1 FLOP per output
    element for every other op that is not a view;
  * bytes: operand plus result bytes of the memory-bound ops the JAX
    walker lists (``_MEM_PRIMS``): products, convolutions, gathers and
    indexing, scatters and ``index_put``, sorts, cumulative scans, and
    copies into slices (``copy_``, the JAX ``dynamic_update_slice``).
    Elementwise ops are taken as fused and move no bytes, as in JAX;
    views count nothing.

Matrix-product FLOPs are split by dtype (bf16/fp16, f32), beside the
"other" ops: the H100's peaks differ by dtype (``bound_s``).  Backward
ops, recomputation under ``torch.utils.checkpoint`` included, are counted
when fn runs a backward, as the JAX grad jaxpr counts them.  A Python
loop is counted as many times as it runs, so the JAX walker's scan
``length`` multiplier has no counterpart.  Collectives count nothing here
(launch/collectives.py records them).

A hand-written kernel is opaque to a dispatch mode, so its wrapper
``report``s the kernel's analytic FLOPs and bytes to the open counters,
and runs its plain version (on the CPU) under ``quiet()``, so that its
ops are not counted as well.  On the ``meta`` device a wrapper launches
nothing and returns an empty output of the right shape, which lets a
whole step be counted from shapes alone.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

# NVIDIA H100 SXM data sheet, dense rates
PEAK_BF16 = 989e12          # FLOP/s, bf16 and fp16 tensor cores
PEAK_TF32 = 495e12          # FLOP/s, f32 products on the tensor cores (TF32)
PEAK_F32 = 67e12            # FLOP/s, f32 outside the tensor cores
HBM_BW = 3.35e12            # B/s

_DOTS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot"}
_CONVS = {"convolution", "convolution_backward"}
_MEM = _DOTS | _CONVS | {
    "index", "index_select", "gather", "embedding", "take",
    "embedding_dense_backward", "scatter", "scatter_add", "scatter_reduce",
    "index_put", "_index_put_impl", "index_add", "index_copy",
    "masked_scatter", "sort", "cumsum", "cumprod", "cummax", "cummin",
    "logcumsumexp", "_logcumsumexp", "slice_scatter", "select_scatter",
    "copy_"}
# no arithmetic: allocation, aliasing and host reads
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "detach", "lift_fresh", "_local_scalar_dense",
         "set_", "resize_", "record_stream"}

_OPEN: list = []        # the counters of the op_costs calls in progress


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for e in x:
            yield from _tensors(e)


def _bytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _elems(x) -> int:
    return sum(t.numel() for t in _tensors(x))


def dtype_class(dtype) -> str:
    """"bf16" (bf16 and fp16: the 989 TFLOP/s tensor-core rate), "f32",
    or "other"."""
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    return "f32" if dtype == torch.float32 else "other"


def _dot_flops(name: str, args) -> tuple:
    """(FLOPs, the operands' dtype class) of a matrix product."""
    if name in ("addmm", "baddbmm", "addbmm", "addmv"):
        args = args[1:]                      # (bias, a, b)
    a, b = args[0], args[1]
    if name == "dot":
        n = 2 * a.numel()
    elif name in ("mv", "addmv"):
        n = 2 * a.shape[0] * a.shape[1]
    elif name in ("mm", "addmm"):
        n = 2 * a.shape[0] * a.shape[1] * b.shape[1]
    else:                                    # [batch, m, k] x [batch, k, n]
        n = 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    return n, dtype_class(a.dtype)


def _conv_flops(name: str, args, out) -> tuple:
    if name == "convolution":
        x, w = args[0], args[1]
        return 2 * _elems(out) * int(np.prod(w.shape[1:])), dtype_class(x.dtype)
    # convolution_backward(grad_out, input, weight, ..., output_mask): the
    # input and the weight gradients each cost the forward's products
    g, w, mask = args[0], args[2], args[-1]
    fwd = 2 * g.numel() * int(np.prod(w.shape[1:]))
    return fwd * (int(mask[0]) + int(mask[1])), dtype_class(g.dtype)


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.acc = defaultdict(int)
        self.quiet = 0

    def add(self, flops: int, nbytes: int, cls: str, dot: bool):
        key = f"dot_flops_{cls}" if dot and cls != "other" else "other_flops"
        self.acc[key] += flops
        self.acc["bytes"] += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.quiet or func.namespace not in ("aten", "prims") \
                or func.is_view:
            return out
        name = func.overloadpacket.__name__
        if name in _FREE:
            return out
        nbytes = _bytes(args) + _bytes(out) if name in _MEM else 0
        if name in _DOTS:
            flops, cls = _dot_flops(name, args)
            self.add(flops, nbytes, cls, True)
            if name.startswith("add"):                        # the bias add
                self.add(_elems(out), 0, "other", False)
        elif name in _CONVS:
            flops, cls = _conv_flops(name, args, out)
            self.add(flops, nbytes, cls, True)
        else:
            self.add(_elems(out), nbytes, "other", False)
        return out

    def costs(self) -> dict:
        a = self.acc
        out = {"dot_flops_bf16": a["dot_flops_bf16"],
               "dot_flops_f32": a["dot_flops_f32"],
               "other_flops": a["other_flops"], "bytes": a["bytes"],
               "reported_flops": a["reported_flops"],
               "reported_bytes": a["reported_bytes"],
               "reported_calls": a["reported_calls"]}
        out["flops"] = (out["dot_flops_bf16"] + out["dot_flops_f32"]
                        + out["other_flops"])
        return out


def report(flops: int, nbytes: int, dtype) -> None:
    """A hand-written kernel's analytic work, added to every open counter
    (as products in `dtype`'s class) unless it is quiet."""
    for c in _OPEN:
        if not c.quiet:
            c.add(int(flops), int(nbytes), dtype_class(dtype), True)
            c.acc["reported_flops"] += int(flops)
            c.acc["reported_bytes"] += int(nbytes)
            c.acc["reported_calls"] += 1


@contextlib.contextmanager
def quiet():
    """Within the block no open counter counts (a wrapper's plain
    version, whose work its report already holds)."""
    for c in _OPEN:
        c.quiet += 1
    try:
        yield
    finally:
        for c in _OPEN:
            c.quiet -= 1


def counting() -> bool:
    """True inside op_costs: kernel wrappers report their work."""
    return bool(_OPEN)


def op_costs(fn, *args, **kw) -> dict:
    """The FLOPs (``dot_flops_bf16``, ``dot_flops_f32``, ``other_flops``
    and their sum ``flops``) and ``bytes`` of fn(*args, **kw), counted as
    it runs (on meta tensors: from shapes alone), with the part the
    kernel wrappers reported (``reported_flops``, ``reported_bytes``, in
    ``reported_calls`` calls)."""
    counter = _Counter()
    _OPEN.append(counter)
    try:
        with counter:
            fn(*args, **kw)
    finally:
        _OPEN.remove(counter)
    return counter.costs()


def bound_s(costs: dict, tf32: bool = False) -> dict:
    """The least time one H100 could take for `costs`: the larger of the
    FLOPs at each dtype's peak (bf16/fp16 products at 989e12, f32
    products at 495e12 with TF32 on or else 67e12, other ops at 67e12)
    and the bytes at 3.35e12 B/s.  {bound_s, bound_by, compute_s,
    memory_s}."""
    compute = (costs["dot_flops_bf16"] / PEAK_BF16
               + costs["dot_flops_f32"] / (PEAK_TF32 if tf32 else PEAK_F32)
               + costs["other_flops"] / PEAK_F32)
    memory = costs["bytes"] / HBM_BW
    return {"bound_s": max(compute, memory),
            "bound_by": "operations" if compute >= memory else "bytes",
            "compute_s": compute, "memory_s": memory}
