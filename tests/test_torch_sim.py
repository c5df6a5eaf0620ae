"""Port vs JAX package: the simulation serving subsystem (repro_torch.sim).

tests/test_sim.py's own bodies run on the port (tests/port_cases.py:
imports pointed at repro_torch, device="cpu" on every NNSimBackend, the
policy net's and the LM's weights built by the JAX package from its key
and carried across), each one a case of one parametrised test: the NN
backend's row independence, SimServer's split submits, padding,
priority order and deferred finalize, SimCache's LRU and bit-identical
hits, and the LM continuation backend's determinism.

The body that reaches JAX internals (``_infer`` with ``jax.device_get``)
has a hand-written counterpart here, listed in ``UNPORTED``.
"""

import numpy as np
import pytest

import port_cases

UNPORTED = {
    "test_vectorized_evaluate_matches_rowwise_reference":
        "reaches repro.envs.policy_net._infer and jax.device_get; stand-in: "
        "test_evaluate_matches_rowwise_reference below",
}
CASES = port_cases.cases("test_sim", UNPORTED)
# the module-scoped fixture test_sim.py's bodies ask for, as it builds it
# on the port: NNSimBackend(GomokuEnv(), JAX's init_params(key 0, C=8))
nn_backend = port_cases.port_module("test_sim").nn_backend


@pytest.mark.parametrize("fn,kwargs", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_jax_sim_case_on_port(fn, kwargs, request):
    """One test of tests/test_sim.py, its own body run against
    repro_torch."""
    port_cases.run_case(fn, kwargs, request)


def test_evaluate_matches_rowwise_reference(nn_backend):
    """Stand-in for test_sim.py::test_vectorized_evaluate_matches_rowwise_
    reference: the one-pass numpy evaluate equals a per-row reference
    with the same masked-softmax semantics, bit for bit, on the logits
    and values of the backend's own (fixed-shape) forward."""
    states = port_cases.port_module("test_sim")._gomoku_states(48, seed=1)
    vals, pris = nn_backend.evaluate(states)
    values, logits = nn_backend.forward_result(nn_backend.dispatch(states))
    for i, st in enumerate(states):
        if st[1] != 0:
            w, me = st[2], st[0]
            exp_v = np.float32(0.0 if w == 0 else (1.0 if w == me else -1.0))
            exp_p = np.zeros(36, np.float32)
        else:
            exp_v = np.float32(values[i])
            legal = st[3:39] == 0
            z = np.where(legal, logits[i], np.float32(-np.inf))
            ez = np.exp(z - z.max())
            soft = ez / ez.sum()
            exp_p = np.zeros(36, np.float32)
            exp_p[: legal.sum()] = soft[legal]
        assert vals[i] == exp_v, i
        np.testing.assert_array_equal(pris[i], exp_p, err_msg=str(i))
