"""Flash-attention kernel wrapper: csrc/flash_attention.cu behind the
JAX package's ``flash_attention(q, k, v, causal=, window=)`` signature.

Replaces the TPU kernel ``repro.kernels.flash_attention.flash_attention``
(``_flash_kernel``): FlashAttention-2 forward with an f32 online softmax,
causal masking that stops at the diagonal block, sliding windows that
skip the key blocks left of the window, GQA through ``h // (H / Hkv)``
and ragged Sq / Sk.  The LM's prefill runs it (``impl="flash"``).

``flash_attention`` launches the CUDA kernel on CUDA tensors, or runs the
plain version (``flash_attention_plain`` = models.attention's
``naive_attention`` with the same masks, cast to q's dtype) on CPU
tensors.  On a CUDA tensor it launches the kernel or raises; it never
falls back.  ``launches`` counts kernel launches.  On meta tensors (a
step counted from shapes, launch/roofline.py) it launches nothing and
returns an empty meta output.  Under launch.roofline.op_costs it reports
the function's FLOPs and bytes (``costs``), and its plain version runs
uncounted.

bf16 runs on the tensor cores (wgmma) with q, k and v brought in by TMA,
which needs each tensor's base address and its batch, seq and head
strides to be multiples of 16 bytes (8 bf16 elements): the LM's
contiguous projections and ``[B,S,H,dh]`` views of a fused projection
are; ``check_tma_layout`` refuses anything else, naming the stride.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.launch import roofline

NAME = "flash_attention"
HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = {torch.float32: "flash_fwd_f32", torch.bfloat16: "flash_fwd_bf16"}
# The bf16 kernel's output against the plain version run in f32 on the same
# bf16 inputs: it computes in f32 and rounds once, so the two differ by at
# most half a bf16 ulp (<= 2^-8 |out|) on top of the f32 tolerance.
BF16_ROUND_TOL = (2e-5, 2e-5 + 2.0 ** -8)                  # atol, rtol
launches = 0

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# q k v o; B Sq Sk H Hkv dh; 12 strides; causal window; scale; stream
ARGTYPES = [_P] * 4 + [_I] * 6 + [_L] * 12 + [_I] * 2 + [ctypes.c_float, _P]
_IP = ctypes.POINTER(ctypes.c_int)
ENTRY_POINTS = {**{fn: ARGTYPES for fn in DTYPES.values()},
                "flash_bf16_config": [_I, _IP, _IP]}


def flash_attention_plain(q, k, v, *, causal=True, window=None):
    """The plain version: the port's naive_attention, in q's dtype."""
    from repro_torch.models.attention import naive_attention
    return naive_attention(q, k, v, causal=causal, window=window).to(q.dtype)


def attended_pairs(Sq: int, Sk: int, causal: bool, window) -> int:
    """(query, key) pairs inside the mask: key j of query i when j <= i
    (causal) and j > i - window (a window)."""
    i = np.arange(Sq)
    hi = np.minimum(i + 1, Sk) if causal else np.full(Sq, Sk)
    lo = np.maximum(0, i - window + 1) if window is not None else np.zeros(Sq)
    return int(np.maximum(hi - lo, 0).sum())


def costs(q, k, v, causal=True, window=None) -> tuple:
    """(FLOPs, bytes) of the function: 4 * B * H * dh per attended pair
    (QK^T and PV), and q, k, v read and the output written once."""
    B, Sq, H, dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    flops = 4 * B * H * dh * attended_pairs(Sq, Sk, causal, window)
    nbytes = q.element_size() * (2 * B * Sq * H * dh + 2 * B * Sk * Hkv * dh)
    return flops, nbytes


def _check(q, k, v, causal, window):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, S, heads, head_dim]")
    B, Sq, H, dh = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != dh:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    Hkv = k.shape[2]
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"H={H} is not a multiple of Hkv={Hkv}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {dh} not in {HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must all be float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if causal and k.shape[1] != Sq:
        raise ValueError(f"causal attention needs Sq == Sk (query 0 at key "
                         f"0), got Sq={Sq}, Sk={k.shape[1]}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: the head_dim axis must be contiguous")


def check_tma_layout(name, t):
    """Raise ValueError unless TMA can read ``t`` ([B, S, heads, dh]): a
    16-byte aligned base and batch / seq / head strides that are multiples
    of 16 bytes.  A dimension of size 1 is never stepped, so its stride
    is not checked."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: base address {t.data_ptr():#x} is not "
                         f"16-byte aligned (TMA)")
    for dim, axis in enumerate(("batch", "seq", "head")):
        if t.shape[dim] > 1 and (t.stride(dim) * t.element_size()) % 16:
            raise ValueError(
                f"{name}: {axis} stride {t.stride(dim)} elements "
                f"({t.stride(dim) * t.element_size()} bytes) is not a "
                f"multiple of 16 bytes (TMA)")


def flash_attention(q, k, v, *, causal=True, window=None):
    """q: [B, Sq, H, dh]; k/v: [B, Sk, Hkv, dh] (H % Hkv == 0), float32
    or bfloat16, read through their strides.  Returns [B, Sq, H, dh] in
    q's dtype.  The launch goes on the current stream and does not
    synchronise."""
    global launches
    _check(q, k, v, causal, window)
    dev = q.device
    if roofline.counting():
        roofline.report(*costs(q, k, v, causal, window), q.dtype)
    if dev.type == "meta":
        return torch.empty(q.shape, dtype=q.dtype, device=dev)
    if dev.type == "cpu":
        with roofline.quiet():
            return flash_attention_plain(q, k, v, causal=causal, window=window)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda (or cpu: plain; "
                         f"meta: shapes), not {dev}")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            check_tma_layout(name, t)
    B, Sq, H, dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, H, dh), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    lib = build.load(NAME, ENTRY_POINTS)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    scale = float(1.0 / np.sqrt(dh))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, DTYPES[q.dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Sk, H, Hkv, dh, *strides, int(bool(causal)),
            -1 if window is None else int(window), scale, stream)
    build.check(NAME, rc)
    launches += 1
    return out


def bf16_config(dh: int) -> dict:
    """The bf16 kernel's launch configuration at head dim ``dh`` (CUDA
    only; launches nothing): dynamic shared memory per CTA and CTAs per SM."""
    smem, ctas = ctypes.c_int(), ctypes.c_int()
    build.check(NAME, build.load(NAME, ENTRY_POINTS).flash_bf16_config(
        dh, ctypes.byref(smem), ctypes.byref(ctas)))
    return {"smem_bytes": smem.value, "ctas_per_sm": ctas.value}
