"""The JAX package's serving suites on the port: tests/test_serving.py
(ragged continuous batching equals per-sequence greedy decoding) and
tests/test_batcher.py (admission mid-decode, eviction causes,
backpressure, deterministic replay, gauges), their own bodies run
against repro_torch through tests/port_cases.py, each one a case of one
parametrised test.  Their ``greedy_reference`` is the ported one
(``port_cases.SHIMS``), so the reference decodes on the port too.
"""

import jax
import pytest

import port_cases
from repro_torch import configs as tconfigs

CASES = [c for m in ("test_serving", "test_batcher")
         for c in port_cases.cases(m, {})]


@pytest.fixture(scope="module")
def model():
    """The two suites' fixture on the port: the smoke llama3.2-1b config
    and the JAX package's weights for PRNGKey(0), carried across."""
    cfg = tconfigs.get_config("llama3.2-1b", smoke=True)
    return cfg, port_cases.jax_key_lm.init_params(cfg, jax.random.PRNGKey(0))


@pytest.mark.parametrize("fn,kwargs", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_jax_serving_case_on_port(fn, kwargs, request):
    """One test of tests/test_serving.py or tests/test_batcher.py, its own
    body run against repro_torch (port_cases)."""
    port_cases.run_case(fn, kwargs, request)
