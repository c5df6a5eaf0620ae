"""Port vs JAX package: the SearchClient handle API and the tracer.

  * every schedule policy (round-robin, weighted-queue-depth with its
    cross-pool fused Simulation batch, deadline-aware) over a
    three-shape-class request mix, through repro.service.SearchClient and
    through the port's: each request's SearchResult must be identical,
    and the weighted policy's fused batches must really span pools on
    both;
  * the cases of tests/test_client.py (its shard placement and overlap
    drain cases included) and tests/test_obs.py, their own bodies run on
    the port (tests/port_cases.py), each one a case of one parametrised
    test.

The JAX runs are cached per module.  Everything runs on the CPU.
"""

import pytest

import port_cases
from repro.core import TreeConfig as JCfg
from repro.envs import BanditTreeEnv as JEnv, BanditValueBackend as JValue
from repro.service import SearchClient as JClient, SearchRequest as JRequest
from repro_torch.core import TreeConfig
from repro_torch.envs import BanditTreeEnv, BanditValueBackend
from repro_torch.service import POLICY_NAMES, SearchClient, SearchRequest
from test_torch_service import assert_results_identical

XPOOL = [dict(X=160, F=4, D=6), dict(X=128, F=4, D=5), dict(X=96, F=4, D=4)]
_JAX: dict = {}


def run_mix(client_cls, cfg_cls, env_cls, value_cls, request_cls, policy,
            **kw):
    """test_executor_matrix.py's cross-pool mix (three shape classes,
    G=2, p=4), one request cancelled mid-flight and one with a deadline
    it cannot meet; returns ({uid: SearchResult}, xpool batches)."""
    cfgs = [cfg_cls(**c) for c in XPOOL]
    cl = client_cls(env_cls(fanout=4, terminal_depth=10), value_cls(), G=2,
                    p=4, policy=policy, **kw)
    try:
        handles = [cl.submit(request_cls(uid=i, seed=50 + i, budget=3,
                                         moves=1 + i % 2, keep_tree=True,
                                         cfg=cfgs[i % 3]))
                   for i in range(6)]
        doomed = cl.submit(request_cls(uid=6, seed=9, budget=40, moves=2,
                                       cfg=cfgs[0]), deadline_supersteps=5)
        victim = cl.submit(request_cls(uid=7, seed=11, budget=4, moves=3,
                                       cfg=cfgs[1]))
        cl.run_until(lambda c: len(c.core.move_log.get(7, [])) >= 1)
        assert victim.cancel()
        done = {h.uid: h.result() for h in handles + [doomed, victim]}
        assert done[6].deadline_evicted and done[7].cancelled
        return done, cl.core.xpool_batches
    finally:
        cl.close()


@pytest.mark.parametrize("policy", POLICY_NAMES)
@pytest.mark.parametrize("executor", ["reference", "cuda"])
def test_policies_match_jax(policy, executor):
    """Acceptance: each policy gives, request for request, the JAX
    client's results under the same policy, cancel and deadline eviction
    included; the weighted policy fuses Simulation across pools."""
    if policy not in _JAX:
        _JAX[policy] = run_mix(JClient, JCfg, JEnv, JValue, JRequest, policy,
                               executor="reference")
    want, want_x = _JAX[policy]
    got, got_x = run_mix(SearchClient, TreeConfig, BanditTreeEnv,
                         BanditValueBackend, SearchRequest, policy,
                         executor=executor, device="cpu")
    assert_results_identical(got, want, f"{policy}/{executor}")
    assert got_x == want_x
    if policy == "weighted-queue-depth":
        assert got_x > 0


UNPORTED: dict = {}
CASES = [c for m in ("test_client", "test_obs")
         for c in port_cases.cases(m, UNPORTED)]


@pytest.mark.parametrize("fn,kwargs", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_jax_client_case_on_port(fn, kwargs, request):
    """One test of the JAX package's client and obs suites, its own body
    run against repro_torch (port_cases)."""
    port_cases.run_case(fn, kwargs, request)
