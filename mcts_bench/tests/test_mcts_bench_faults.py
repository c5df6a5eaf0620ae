"""A whole run on the CPU at a small size, with the program broken
underneath, must come out not correct; sound, it must come out correct.
And the control (the reference one precision down, in the program's
place) must fail the check.  The faults a cell here can have: a step
that leaves the tree as it was (BackUp dropped), half of a simulation
batch replaced by the mean of the rest, and an answer altered where it
is produced (the committed action).  No cell spans chips, so no exchange
between chips can be left out."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(REPO), str(REPO / "src")]

from mcts_bench import cell, control, manifest  # noqa: E402

SEED = 2 ** 31 + 101
SMALL = {
    "pong.blitz": dict(
        config=dict(tree=dict(X=1500), server=dict(G=3, p=8)),
        cell=dict(loop=dict(clients=6), warm_ticks=4, check_searches=4,
                  searches=dict(budget=[4, 10], moves=[2, 4]))),
    "gomoku.selfplay": dict(
        config=dict(tree=dict(X=1200), server=dict(G=2, p=8)),
        cell=dict(loop=dict(clients=4), warm_ticks=2, check_searches=3,
                  searches=dict(budget=[3, 6], moves=[1, 2]))),
}


def small_run(name: str, seconds: float = 1.0) -> dict:
    torch.set_num_threads(1)
    return cell.run(name, SEED, seconds, False, device="cpu",
                    overrides=SMALL[name])


def half_mean(values):
    """The second half of a batch replaced by the mean of the first."""
    flat = values.reshape(-1)
    half = flat.shape[0] // 2
    flat[half:] = flat[:half].mean()
    return values


@pytest.mark.parametrize("name", list(SMALL))
def test_sound_run_is_correct(name):
    out = small_run(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["checks"]["moves_compared"]["value"] > 0


@pytest.mark.parametrize("name", list(SMALL))
def test_step_leaving_the_tree_unchanged_is_caught(name, monkeypatch):
    from repro_torch.kernels import uct_backup

    monkeypatch.setattr(uct_backup, "backup_arena", lambda *a, **k: None)
    out = small_run(name)
    assert not out["correct"]
    assert out["checks"]["moves_mismatched"]["value"] > 0


def test_half_the_batch_as_the_mean_is_caught_pong(monkeypatch):
    from repro_torch.envs import BanditValueBackend

    ev, dev = BanditValueBackend.evaluate, BanditValueBackend.evaluate_device
    monkeypatch.setattr(BanditValueBackend, "evaluate",
                        lambda self, s: (half_mean(ev(self, s)[0]), None))
    monkeypatch.setattr(BanditValueBackend, "evaluate_device",
                        lambda self, s: half_mean(dev(self, s).clone()))
    out = small_run("pong.blitz")
    assert not out["correct"]
    assert out["checks"]["moves_mismatched"]["value"] > 0


def test_half_the_batch_as_the_mean_is_caught_gomoku(monkeypatch):
    from repro_torch.sim import CachedSimBackend

    ev = CachedSimBackend.evaluate

    def broken(self, states):
        v, p = ev(self, states)
        return half_mean(v.copy()), p
    monkeypatch.setattr(CachedSimBackend, "evaluate", broken)
    out = small_run("gomoku.selfplay")
    assert not out["correct"]
    assert out["checks"]["value_gap"]["value"] > \
        out["checks"]["value_gap"]["limit"]


@pytest.mark.parametrize("name", list(SMALL))
def test_an_altered_answer_is_caught(name, monkeypatch):
    from repro_torch.core.executor import TorchExecutor

    best = TorchExecutor.best_actions
    monkeypatch.setattr(TorchExecutor, "best_actions",
                        lambda self: np.where(best(self) == 0, 1, 0))
    out = small_run(name)
    assert not out["correct"]
    assert out["checks"]["moves_mismatched"]["value"] > 0


def test_bandit_control_fails_the_check():
    """Float32 values rounded to bfloat16 move the trees: the control's
    moves differ from the reference's on every seed (at a size where
    moves take enough supersteps for a value to matter)."""
    w = cell.merge(manifest.workload("pong.blitz"), dict(
        check_searches=3, searches=dict(budget=[24, 40], moves=[2, 3])))
    c = cell.merge(manifest.config("pong"), dict(tree=dict(X=1500)))
    limit = c["limits"]["moves_mismatched"]
    for seed in (1, 2, 3):
        out = control.bandit_control(w, c, seed)
        assert out["moves_compared"] > 0
        assert out["control_moves_mismatched"] > limit


def test_net_control_fails_the_check_and_the_program_passes():
    """The TF32 net's gaps to the float64 reference pass the limits that
    the program's float32 net keeps within."""
    torch.set_num_threads(1)
    limits = manifest.config("gomoku")["limits"]
    out = control.net_control("gomoku.selfplay", SEED, 1.0,
                              overrides=SMALL["gomoku.selfplay"])
    assert out["rows"] > 0
    assert out["program"]["value_gap"] <= limits["value_gap"]
    assert out["program"]["prior_gap"] <= limits["prior_gap"]
    assert out["control_value_gap"] > limits["value_gap"]


def test_sample_covers_every_slot_and_the_longest():
    """The check's sample holds a search of every slot seen (a fault
    confined to one slot cannot slip by), one of each uid class modulo the
    slot count for searches whose slot was not seen, and the longest."""
    from mcts_bench import check
    from mcts_bench.loop import Search

    class Loop:
        t0, t1 = 0.0, 10.0

    loop = Loop()
    loop.searches = []
    for uid in range(40):
        s = Search(spec=dict(uid=uid, budget=200 if uid == 17 else 8),
                   client=0, asks=[11.0 if uid == 3 else 1.0],
                   moves=[(0, None)])
        s.slot = (0, uid % 5) if uid < 30 else None
        loop.searches.append(s)
    picked = check.sample(loop, 2, SEED, slots=5)
    uids = [s.spec["uid"] for s in picked]
    assert 3 not in uids            # asked after the window
    assert 17 in uids               # the longest
    assert {s.slot for s in picked if s.slot is not None} == \
        {(0, g) for g in range(5)}
    assert {u % 5 for u in uids if u >= 30} == set(range(5))
    assert check.slots_covered(picked) == 5
    assert uids == sorted(set(uids))
    assert check.sample(loop, 2, SEED, slots=5) == picked   # from the seed


def test_cells_start_with_their_host_env():
    """run.py starts the process with the environment a cell's file names
    ("host_env"), and with nothing for a name it cannot find."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "mcts_bench_run", REPO / "mcts_bench" / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    for name in [w["name"] for w in manifest.benchmark()["workloads"]]:
        want = manifest.workload(name)["host_env"]
        assert run.host_env(["run.py", "--workload", name]) == want
        assert "glibc.malloc.mmap_threshold" in want["GLIBC_TUNABLES"]
    assert run.host_env(["run.py", "--workload", "../BENCHMARK"]) == {}
    assert run.host_env(["run.py", "--workload", "no.such_cell"]) == {}
    assert run.host_env(["run.py"]) == {}
