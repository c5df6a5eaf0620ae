"""Policy-value network for Gomoku (the paper's DNN Simulation backend), on
torch: the port of repro.envs.policy_net.

A small AlphaZero-style convnet: two 3x3 conv blocks, a policy head (1x1
conv -> 36 logits) and a value head (tanh scalar).  The JAX package's
``apply`` is plain ``conv_general_dilated`` and ``@`` outside any Pallas
kernel, so here it is ``torch.nn.functional.conv2d`` and ``torch.matmul``.

Parameters are a dict of float32 tensors in the port's layout: conv
kernels OIHW (torch's), the three matrices ``[in, out]`` as in the JAX
package, whose rows follow the JAX net's NHWC flatten order (the forward
permutes its NCHW activations to NHWC before flattening).
``params_from_numpy`` carries the JAX package's ``init_params`` dict
(HWIO kernels) across, so both nets compute the same function.

Numerics: the forward runs with TF32 off for the convolutions and the
matrix products, and with cuDNN deterministic and not benchmarking, set
for the forward alone.  A row's result must not depend on the batch it
came in (the serving layer's bit-identity rests on it: cache-on equals
cache-off, SimServer's coalescing), but a library may pick another
kernel for another row count (the unpadded net's rows change in their
last bits between batch sizes on the H100 and on the CPU alike:
chip_smoke.py phase 12 reports it); so NNSimBackend runs every forward at
``FORWARD_ROWS`` rows, padding with copies of the first row and cutting
larger batches into chunks of that count.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.tree import resolve_device

_BOARD = 6
_CELLS = _BOARD * _BOARD
FORWARD_ROWS = 64          # the one row count every forward runs at
PARAM_NAMES = ("c1", "c2", "pol", "pol_w", "val_w1", "val_w2")


def _he_normal(gen: torch.Generator, shape, fan_in: int) -> torch.Tensor:
    """jax.nn.initializers.he_normal: a normal truncated at two standard
    deviations, scaled so its variance is 2 / fan_in."""
    std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
    t = torch.empty(shape, dtype=torch.float32)
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=gen)


def init_params(generator: torch.Generator, channels: int = 32) -> dict:
    """He-normal weights (the JAX package's init, from a torch.Generator:
    the values differ from JAX's, the distribution does not)."""
    C, g = channels, generator
    return {
        "c1": _he_normal(g, (C, 2, 3, 3), 2 * 9),
        "c2": _he_normal(g, (C, C, 3, 3), C * 9),
        "pol": _he_normal(g, (2, C, 1, 1), C),
        "pol_w": _he_normal(g, (2 * _CELLS, _CELLS), 2 * _CELLS),
        "val_w1": _he_normal(g, (C * _CELLS, 64), C * _CELLS),
        "val_w2": _he_normal(g, (64, 1), 64),
    }


def params_from_numpy(params: dict) -> dict:
    """The JAX package's ``init_params`` dict, as numpy arrays, in the
    port's layout: HWIO conv kernels to OIHW; the matrices unchanged."""
    out = {}
    for k in PARAM_NAMES:
        t = torch.from_numpy(np.array(params[k], np.float32))
        out[k] = t.permute(3, 2, 0, 1).contiguous() if t.dim() == 4 else t
    return out


@contextlib.contextmanager
def exact_f32():
    """TF32 off for cuDNN convolutions and cuBLAS products, cuDNN
    deterministic and not benchmarking; each restored on exit."""
    mm = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm


class PolicyValueNet(nn.Module):
    """``repro.envs.policy_net.apply`` as a module: boards ``[B, 6, 6]``
    canonicalized (+1 = player to move) -> (values [B], logits [B, 36])."""

    def __init__(self, params: dict):
        super().__init__()
        for k in PARAM_NAMES:
            self.register_parameter(
                k, nn.Parameter(params[k].detach().clone(),
                                requires_grad=False))

    def forward(self, boards: torch.Tensor):
        x = torch.stack([(boards > 0).float(), (boards < 0).float()], dim=1)
        x = F.relu(F.conv2d(x, self.c1, padding=1))
        x = F.relu(F.conv2d(x, self.c2, padding=1))
        pol = F.conv2d(x, self.pol)
        B = boards.shape[0]
        logits = pol.permute(0, 2, 3, 1).reshape(B, -1) @ self.pol_w
        v = F.relu(x.permute(0, 2, 3, 1).reshape(B, -1) @ self.val_w1)
        values = torch.tanh(v @ self.val_w2)[:, 0]
        return values, logits


def canonical_boards(states: np.ndarray) -> np.ndarray:
    """[B, 36] float32 boards from the player to move's side (+1 = mover)."""
    return (states[:, 3 : 3 + _CELLS] * states[:, 0:1]).astype(np.float32)


class _Staging:
    """One dispatch's pinned host buffers: the padded boards going up,
    values and logits coming down, and the event after the download."""

    __slots__ = ("rows", "boards", "values", "logits", "event")

    def __init__(self, rows: int):
        self.rows = rows
        self.boards = torch.empty((rows, _CELLS), pin_memory=True)
        self.values = torch.empty(rows, pin_memory=True)
        self.logits = torch.empty((rows, _CELLS), pin_memory=True)
        self.event = torch.cuda.Event()


class _Token:
    __slots__ = ("n", "staging", "values", "logits")

    def __init__(self, n, staging=None, values=None, logits=None):
        self.n, self.staging = n, staging
        self.values, self.logits = values, logits


class NNSimBackend:
    """DNN inference simulation backend (paper Gomoku benchmark).

    evaluate() returns values from the player-to-move perspective and
    priors over *legal actions in legal order* (the driver's action
    indexing), padded to max_actions.

    The forward is split into ``dispatch``/``finalize`` as in the JAX
    package.  On a card, dispatch writes the canonical boards into pinned
    buffers of its own, uploads them with a non-blocking copy, queues the
    forward and the download of values and logits into those pinned
    buffers, records an event, and returns without a host sync; finalize
    waits on that event and runs the numpy post-processing.  Each
    dispatch owns its staging until its finalize, so any number may be in
    flight (SimServer keeps several microbatches in flight).  On the CPU
    (``device="cpu"``) dispatch runs the forward at once.  Runs on CUDA
    unless the caller passes another device; raises without one.
    """

    def __init__(self, env, params: dict, device=None):
        self.env, self.params = env, params
        self.device = resolve_device(device)
        self.net = PolicyValueNet(params).to(self.device)
        self._free: list = []            # staging no dispatch holds

    def forward_rows(self, boards: torch.Tensor):
        """The net over ``[R, 36]`` boards on the backend's device, R a
        multiple of FORWARD_ROWS, one forward per chunk of that count."""
        R = boards.shape[0]
        values = torch.empty(R, dtype=torch.float32, device=boards.device)
        logits = torch.empty((R, _CELLS), dtype=torch.float32,
                             device=boards.device)
        with exact_f32(), torch.no_grad():
            for i in range(0, R, FORWARD_ROWS):
                sl = slice(i, i + FORWARD_ROWS)
                values[sl], logits[sl] = self.net(
                    boards[sl].view(-1, _BOARD, _BOARD))
        return values, logits

    @staticmethod
    def padded(canon: np.ndarray) -> np.ndarray:
        """Pad [B, 36] boards with copies of the first row to a multiple
        of FORWARD_ROWS (at least one chunk)."""
        B = len(canon)
        R = max(1, -(-B // FORWARD_ROWS)) * FORWARD_ROWS
        out = np.empty((R, _CELLS), np.float32)
        out[:B] = canon
        out[B:] = canon[0] if B else 0.0
        return out

    def dispatch(self, states: np.ndarray):
        """Start the forward for a batch; on a card, returns without a
        host sync, the results landing in this dispatch's pinned buffers."""
        states = np.asarray(states, np.float32)
        B = len(states)
        canon = self.padded(canonical_boards(states))
        if self.device.type != "cuda":
            v, lg = self.forward_rows(torch.from_numpy(canon).to(self.device))
            return _Token(B, values=v.numpy(), logits=lg.numpy())
        R = len(canon)
        st = self._staging(R)
        st.boards.numpy()[:R] = canon
        up = st.boards[:R].to(self.device, non_blocking=True)
        v, lg = self.forward_rows(up)
        st.values[:R].copy_(v, non_blocking=True)
        st.logits[:R].copy_(lg, non_blocking=True)
        st.event.record()
        return _Token(B, staging=st)

    def _staging(self, rows: int) -> _Staging:
        for i, st in enumerate(self._free):
            if st.rows >= rows:
                return self._free.pop(i)
        return _Staging(rows)

    def forward_result(self, token: _Token):
        """Wait for a dispatched forward: (values [B], logits [B, 36])
        as numpy copies; the dispatch's staging is free again."""
        B = token.n
        if token.staging is None:
            return token.values[:B], token.logits[:B]
        st = token.staging
        st.event.synchronize()
        values = st.values[:B].numpy().copy()
        logits = st.logits[:B].numpy().copy()
        token.staging = None
        self._free.append(st)
        return values, logits

    def finalize(self, token, states: np.ndarray):
        """Block on a dispatched forward and post-process: terminal rows
        get their exact game value (no priors); the rest get a masked
        softmax over legal cells, compacted into legal order.

        One vectorized numpy pass over all rows.  Each row's result is a
        pure function of that row alone — masked max, exp, and a
        fixed-width 36-cell row sum — which, with the fixed-shape
        forward, is the property the serving layer's bit-identity
        guarantees rest on (batch composition, caching, and padding can
        never change a row's result)."""
        values, logits = self.forward_result(token)
        B = len(states)
        cells = states[:, 3 : 3 + _CELLS]
        term = states[:, 1] != 0
        legal = (cells == 0) & ~term[:, None]
        z = np.where(legal, logits, np.float32(-np.inf))
        m = z.max(axis=1)
        mm = np.where(np.isfinite(m), m, np.float32(0.0))
        ez = np.exp(z - mm[:, None])          # exact 0.0 at masked cells
        denom = ez.sum(axis=1)
        soft = ez / np.where(denom > 0, denom, np.float32(1.0))[:, None]
        pri = np.zeros((B, self.env.max_actions), np.float32)
        # scatter each legal cell's mass to its legal-order column
        pos = np.cumsum(cells == 0, axis=1) - 1
        ii, jj = np.nonzero(legal)
        pri[ii, pos[ii, jj]] = soft[ii, jj]
        w, me = states[:, 2], states[:, 0]
        tv = np.where(w == 0, np.float32(0.0),
                      np.where(w == me, np.float32(1.0), np.float32(-1.0)))
        vals = np.where(term, tv, values).astype(np.float32, copy=False)
        return vals, pri

    def evaluate(self, states: np.ndarray):
        return self.finalize(self.dispatch(states), states)
