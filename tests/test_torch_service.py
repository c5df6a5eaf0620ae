"""Port vs JAX package: the serving stack (repro_torch.service), bit for bit.

  * the executor matrix's request stream (tests/test_executor_matrix.py
    ``_schedule()``: TreeConfig(X=160, F=4, D=6), G=3, p=4; oversubscribed,
    staggered, multi-move) through repro.service.SearchClient with the
    JAX ``reference`` executor and through the port's SearchClient with
    ``reference`` / ``faithful`` / ``cuda`` (the kernel wrappers' plain
    versions on the CPU) x compact in {0.0, 0.5} x expansion in {loop,
    vector}: every SearchResult must be identical (actions, rewards,
    visit counts, supersteps, flags, every field of the tree snapshot);
    the port's relaxed / wavefront against the JAX package's;
  * the cases of tests/test_service.py, tests/test_frontend.py,
    tests/test_executor_matrix.py (its sharded and overlap legs
    included) and tests/test_arena_pallas.py (its "pallas" executor is
    the port's "cuda"), their own bodies run on the port
    (tests/port_cases.py), each one a case of one parametrised test;
  * the fused K-superstep dispatch, D=2 shards and the overlap mode's
    pipelined gangs run through every entry point to the K=1 oracle's
    results.

The JAX runs are cached per module, as test_executor_matrix.py's
_RESULTS does.  Everything runs on the CPU.
"""

import numpy as np
import pytest
import torch

import port_cases
from repro.core import TreeConfig as JCfg
from repro.envs import BanditTreeEnv as JEnv, BanditValueBackend as JValue
from repro.service import SearchClient as JClient, SearchRequest as JRequest
from repro_torch.core import TreeConfig
from repro_torch.envs import BanditTreeEnv, BanditValueBackend
from repro_torch.service import (
    ArenaPool, SearchClient, SearchRequest, SearchService, ServiceFrontend,
)
from test_executor_matrix import _schedule

MATRIX = dict(X=160, F=4, D=6)   # test_executor_matrix.py CFG, G, P
G, P = 3, 4
_JAX: dict = {}


def run_stream(client_cls, cfg_cls, env_cls, value_cls, request_cls,
               executor, compact=0.0, expansion="loop", **kw):
    """The matrix schedule through one SearchClient; returns
    ({uid: SearchResult}, stats)."""
    cl = client_cls(env_cls(fanout=4, terminal_depth=10), value_cls(), G=G,
                    p=P, executor=executor, default_cfg=cfg_cls(**MATRIX),
                    compact_threshold=compact, expansion=expansion, **kw)
    try:
        handles = [cl.submit(request_cls(**r)) for r in _schedule()]
        done = {h.uid: h.result() for h in handles}
        return done, cl.stats
    finally:
        cl.close()


def jax_stream(executor: str):
    if executor not in _JAX:
        _JAX[executor] = run_stream(JClient, JCfg, JEnv, JValue, JRequest,
                                    executor)
    return _JAX[executor]


def port_stream(executor, compact=0.0, expansion="loop"):
    return run_stream(SearchClient, TreeConfig, BanditTreeEnv,
                      BanditValueBackend, SearchRequest, executor, compact,
                      expansion, device="cpu")


def assert_results_identical(got: dict, want: dict, label: str):
    assert sorted(got) == sorted(want), label
    for uid in want:
        a, b = got[uid], want[uid]
        tag = f"{label} uid={uid}"
        assert a.actions == b.actions, tag
        assert a.rewards == b.rewards, tag
        assert a.supersteps == b.supersteps, tag
        assert (a.terminal, a.cancelled, a.deadline_evicted) == (
            b.terminal, b.cancelled, b.deadline_evicted), tag
        assert len(a.visit_counts) == len(b.visit_counts), tag
        for va, vb in zip(a.visit_counts, b.visit_counts):
            np.testing.assert_array_equal(va, vb, err_msg=tag)
        assert (a.tree_snapshot is None) == (b.tree_snapshot is None), tag
        for k in b.tree_snapshot or {}:
            np.testing.assert_array_equal(
                a.tree_snapshot[k], np.asarray(b.tree_snapshot[k]).astype(
                    a.tree_snapshot[k].dtype), err_msg=f"{tag} field={k}")


@pytest.mark.parametrize("executor", ["reference", "faithful", "cuda"])
@pytest.mark.parametrize("compact", [0.0, 0.5], ids=["masked", "compacted"])
@pytest.mark.parametrize("expansion", ["loop", "vector"])
def test_stream_matches_jax_oracle(executor, compact, expansion):
    """Acceptance: the port's SearchClient gives, request for request,
    the JAX SearchClient's results on the numpy oracle (JAX reference),
    for every bit-compatible port executor, masked and compacted."""
    got, stats = port_stream(executor, compact, expansion)
    want, want_stats = jax_stream("reference")
    assert_results_identical(got, want, f"{executor}/{compact}/{expansion}")
    assert stats.supersteps == want_stats.supersteps
    if compact:
        # the drain tail really ran on resident sub-arenas
        assert stats.compacted_supersteps > 0
        assert stats.session_gathers >= 1 and stats.session_scatters >= 1


def test_faithful_stream_matches_jax_faithful():
    """The JAX package's jit executor gives the oracle's results too, so
    the port's faithful executor matches it directly."""
    assert_results_identical(port_stream("faithful")[0],
                             jax_stream("faithful")[0], "faithful")


@pytest.mark.parametrize("executor", ["relaxed", "wavefront"])
@pytest.mark.parametrize("compact", [0.0, 0.5], ids=["masked", "compacted"])
def test_relaxed_and_wavefront_streams_match_jax(executor, compact):
    """The beyond-paper selections change intra-superstep semantics by
    design; the port's must change them exactly as the JAX package's."""
    got, _ = port_stream(executor, compact, "vector")
    assert_results_identical(got, jax_stream(executor)[0], executor)


@pytest.mark.parametrize("kw", [
    dict(supersteps_per_dispatch=4),
    dict(n_shards=2),
    dict(overlap=True),
], ids=["fused-dispatch", "shards", "overlap"])
@pytest.mark.parametrize("entry", ["SearchClient", "ServiceFrontend",
                                   "SearchService", "ArenaPool"])
def test_serving_modes_run_every_entry_point(kw, entry, monkeypatch):
    """Every serving mode runs through every entry point to completion
    with the K=1 lock-step oracle's results: the fused K=4 dispatch
    (with commit escapes), D=2 shards (both shards take work) and the
    overlap mode's two pipelined gangs (both staged)."""
    env, sim = BanditTreeEnv(fanout=4, terminal_depth=10), BanditValueBackend()
    cfg = TreeConfig(**MATRIX)
    make = {
        "SearchClient": lambda: SearchClient(env, sim, G=4, p=P,
                                             default_cfg=cfg, device="cpu",
                                             **kw),
        "ServiceFrontend": lambda: ServiceFrontend(env, sim, G=4, p=P,
                                                   device="cpu", **kw),
        "SearchService": lambda: SearchService(cfg, env, sim, G=4, p=P,
                                               device="cpu", **kw),
        "ArenaPool": lambda: ArenaPool(cfg, env, sim, G=4, p=P,
                                       device="cpu", **kw),
    }[entry]
    seen = {"shards": set(), "gangs": set()}
    place, stage = ArenaPool._place_slot, ArenaPool._stage

    def placed(pool):
        g = place(pool)
        if g is not None:
            seen["shards"].add(pool.shard_of(g))
        return g

    def staged(pool, gang, active):
        seen["gangs"].add(gang)
        return stage(pool, gang, active)

    monkeypatch.setattr(ArenaPool, "_place_slot", placed)
    monkeypatch.setattr(ArenaPool, "_stage", staged)
    got = run_entry(make(), entry)
    monkeypatch.undo()
    want = run_entry(ArenaPool(cfg, env, sim, G=4, p=P, executor="reference",
                               device="cpu"), "ArenaPool")
    assert_results_identical(got[0], want[0], entry)
    if "supersteps_per_dispatch" in kw:
        assert got[1].fused_dispatches > 0 and got[1].fused_escape_commit > 0
    elif "n_shards" in kw:
        assert seen["shards"] == {0, 1}
    else:
        assert seen["gangs"] == {0, 1}


def run_entry(svc, entry: str):
    """Three requests (budgets 3-7, 1-2 moves, trees kept) through one
    entry point, run to completion.  Returns ({uid: SearchResult},
    stats)."""
    reqs = [SearchRequest(uid=i, seed=20 + i, budget=3 + 2 * i,
                          moves=1 + i % 2, keep_tree=True,
                          cfg=TreeConfig(**MATRIX)) for i in range(3)]
    try:
        if entry == "SearchClient":
            hs = [svc.submit(r) for r in reqs]
            return {h.uid: h.result() for h in hs}, svc.stats
        for r in reqs:
            svc.submit(r)
        return {r.uid: r for r in svc.run()}, svc.stats
    finally:
        svc.close()


def test_entry_points_need_a_device():
    """The serving entry point runs on CUDA unless the caller asks for
    the CPU; with no card it raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SearchClient(BanditTreeEnv(fanout=4, terminal_depth=10),
                     BanditValueBackend(), G=2, p=P,
                     default_cfg=TreeConfig(**MATRIX))


class _AsyncSim:
    def submit(self, states): ...
    def collect(self, ticket): ...


class _DeviceTwin:
    def step_device(self, states, actions): ...
    def num_actions_device(self, states): ...
    def evaluate_device(self, states): ...


@pytest.mark.parametrize("obj", [BanditTreeEnv(), BanditValueBackend(),
                                 _AsyncSim(), _DeviceTwin()],
                         ids=["env", "value", "async-sim", "device-twin"])
def test_capability_probes_match_jax(obj):
    """envs.device's probes (the pool asks has_async_sim; the fused
    dispatch of ROADMAP.md queue A item 3 asks the others) answer as the
    JAX package's do."""
    from repro.envs import device as jdev
    from repro_torch.envs import device as tdev

    for name in ("has_device_env", "has_device_sim", "has_async_sim"):
        assert getattr(tdev, name)(obj) == getattr(jdev, name)(obj), name
    rows = tdev.resolvable_device(BanditTreeEnv(), None, torch.zeros(5))
    assert rows.dtype == torch.bool and rows.shape == (5,) and bool(rows.all())


# -- the JAX package's own lock-step cases, run on the port ---------------

UNPORTED = {
    "test_expand_all_puct_service_runs":
        "GomokuEnv and the policy-net backend: ROADMAP.md queue A item 7",
    "test_expand_all_vector_matches_loop":
        "GomokuEnv and the policy-net backend: item 7",
    "test_nn_backend_cache_is_semantics_free":
        "SimServer, the cache and the NN backend: item 7",
    "test_nn_backend_matches_reference": "the NN backend: item 7",
}
CASES = [c for m in ("test_service", "test_frontend", "test_executor_matrix",
                      "test_arena_pallas")
         for c in port_cases.cases(m, UNPORTED)]


@pytest.mark.parametrize("fn,kwargs", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_jax_service_case_on_port(fn, kwargs, request):
    """One test of the JAX package's service suites, its own body run
    against repro_torch (port_cases: imports pointed at the port, the
    port's names for its executors, device="cpu")."""
    port_cases.run_case(fn, kwargs, request)
