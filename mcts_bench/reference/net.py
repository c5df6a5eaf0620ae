"""The plain policy-value net (the Gomoku configuration's simulation).

Two 3x3 convolutions with ReLU over the two stone planes of the mover's
view, a 1x1 policy convolution into a 72 -> 36 matrix, and a value head
(C*36 -> 64 ReLU -> 1, tanh); no biases.  Convolutions as in torch
(cross-correlation, zero padding 1), weights OIHW, matrices [in, out]
with rows in NHWC flatten order.  Numpy in float64 by default; with
precision="tf32" every operand of a convolution or matrix product is
rounded to TF32 (10 mantissa bits) and products accumulate in float32,
as a card's TF32 path computes them.

`evaluate` adds what a simulation returns: terminal rows get their exact
game value; the rest the net's value and a softmax over the legal cells,
in legal order, padded to 36.
"""

from __future__ import annotations

import numpy as np

BOARD, CELLS = 6, 36
PARAM_NAMES = ("c1", "c2", "pol", "pol_w", "val_w1", "val_w2")


def round_tf32(x: np.ndarray) -> np.ndarray:
    """f32 -> the nearest TF32 value (ties to even), held in f32."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0xFFF + ((b >> 13) & 1)) >> 13 << 13
    return b.astype(np.uint32).view(np.float32)


def _conv(x, w, pad, mm):
    """[B, Ci, 6, 6] * [Co, Ci, k, k] -> [B, Co, 6, 6]."""
    k = w.shape[-1]
    xp = np.pad(x, ((0, 0), (0, 0), (pad, pad), (pad, pad)))
    cols = np.stack([xp[:, :, i:i + BOARD, j:j + BOARD]
                     for i in range(k) for j in range(k)], axis=2)
    # cols [B, Ci, k*k, 6, 6] -> [B*36, Ci*k*k]
    B, Ci = x.shape[:2]
    cols = cols.transpose(0, 3, 4, 1, 2).reshape(B * CELLS, Ci * k * k)
    out = mm(cols, w.reshape(w.shape[0], -1).T)
    return out.reshape(B, BOARD, BOARD, -1).transpose(0, 3, 1, 2)


def forward(params: dict, boards: np.ndarray, precision: str = "f64"):
    """boards [B, 36] from the mover's side (+1 = mover) -> (values [B],
    logits [B, 36])."""
    if precision == "tf32":
        dt = np.float32

        def mm(a, b):
            return round_tf32(a) @ round_tf32(b)
    else:
        dt = np.float64

        def mm(a, b):
            return a @ b
    p = {k: np.asarray(params[k], dt) for k in PARAM_NAMES}
    b = np.asarray(boards).reshape(-1, BOARD, BOARD)
    B = len(b)
    x = np.stack([(b > 0), (b < 0)], axis=1).astype(dt)
    x = np.maximum(_conv(x, p["c1"], 1, mm), 0)
    x = np.maximum(_conv(x, p["c2"], 1, mm), 0)
    pol = _conv(x, p["pol"], 0, mm)
    logits = mm(pol.transpose(0, 2, 3, 1).reshape(B, -1), p["pol_w"])
    v = np.maximum(mm(x.transpose(0, 2, 3, 1).reshape(B, -1), p["val_w1"]), 0)
    values = np.tanh(mm(v, p["val_w2"]))[:, 0]
    return values.astype(dt), logits.astype(dt)


def evaluate(params: dict, states: np.ndarray, precision: str = "f64"):
    """Gomoku states [B, 108] -> (values [B], priors [B, 36])."""
    states = np.asarray(states, np.float32)
    cells = states[:, 3:3 + CELLS]
    boards = cells * states[:, 0:1]
    values, logits = forward(params, boards, precision)
    term = states[:, 1] != 0
    legal = (cells == 0) & ~term[:, None]
    priors = np.zeros((len(states), CELLS), values.dtype)
    for i in range(len(states)):
        idx = np.flatnonzero(legal[i])
        if len(idx):
            z = logits[i, idx]
            e = np.exp(z - z.max())
            priors[i, :len(idx)] = e / e.sum()
    winner, me = states[:, 2], states[:, 0]
    exact = np.where(winner == 0, 0.0, np.where(winner == me, 1.0, -1.0))
    return np.where(term, exact, values), priors

