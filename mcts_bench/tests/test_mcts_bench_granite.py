"""The granite4h_small cell on the CPU at SMOKE size (float32): a sound
run comes out correct, and runs with the program broken underneath come
out not correct; the control (the reference with the SSD state and the
router in bfloat16) fails the check.

The configuration's `logit_gap` and `value_gap` are set on the card for
the bfloat16 model; here the model is float32, whose program gaps are
float32 rounding (under 2e-6), so the run takes float32 limits of its
own, 1e-5 and 1e-4: the control's bfloat16 reads about 3e-4 and 8e-4
here, and the faults 1e-3 and more."""

import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(REPO), str(REPO / "src")]

from mcts_bench import cell, manifest  # noqa: E402
from mcts_bench.systems import granite_hybrid as gh  # noqa: E402

NAME = "granite4h_small.token_mcts"
SEED = 2 ** 31 + 101
SMALL = dict(
    config=dict(model=dict(preset="SMOKE"), tree=dict(X=200),
                lm=dict(prompt_tokens=[24, 40], pool_size=8),
                limits=dict(logit_gap=1e-5, value_gap=1e-4)),
    cell=dict(warm_ticks=6, check_searches=2, searches=dict(moves=[2, 3])))


def small_run(seconds: float = 2.5, trace: bool = False) -> dict:
    """A window of a few seconds: on a loaded CPU a SMOKE superstep takes
    up to half a second, and the check needs moves asked and committed
    inside the window."""
    torch.set_num_threads(1)
    return cell.run(NAME, SEED, seconds, trace, device="cpu",
                    overrides=SMALL)


def test_sound_traced_run_is_correct_and_reads_every_metric():
    out = small_run(trace=True)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    checks = {k: c["value"] for k, c in out["checks"].items()}
    assert checks["moves_compared"] > 0 and checks["net_rows_checked"] > 0
    assert checks["moe_tokens_dropped"] == 0
    _, layer = manifest.cell_metrics(manifest.benchmark(), NAME)
    assert {m["name"] for m in layer} == set(out["metrics"])
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert out["metrics"]["lm.prefix_reuse_pct"]["value"] < 100


def test_an_altered_answer_is_caught(monkeypatch):
    import numpy as np
    from repro_torch.core.executor import TorchExecutor

    best = TorchExecutor.best_actions
    monkeypatch.setattr(TorchExecutor, "best_actions",
                        lambda self: np.where(best(self) == 0, 1, 0))
    out = small_run()
    assert not out["correct"]
    assert out["checks"]["moves_mismatched"]["value"] > 0


def test_a_snapshot_not_advanced_at_a_commit_is_caught(monkeypatch):
    """The commit re-keys the root snapshot under its new tokens but runs
    nothing: every later state is forwarded without the committed token.
    (Warm-up ticks are counted, so commits have happened by the window.)"""
    from repro_torch.sim import lm as slm

    def skipped(self, snap, toks):
        snap.tokens, snap.users = toks, 1
        self._live[toks.tobytes()] = snap
    monkeypatch.setattr(slm.LMTreeEnv, "_advance", skipped)
    out = small_run()
    assert not out["correct"]
    assert out["checks"]["logit_gap"]["value"] > \
        out["checks"]["logit_gap"]["limit"]


def test_a_continuation_without_its_ssd_state_is_caught(monkeypatch):
    """Admission from a snapshot leaves the row's conv tails and SSD
    states at zero (its attention K/V copied, its suffix run)."""
    from repro_torch.serving import batcher

    prefill = batcher.ContinuousBatcher._prefill_row

    def no_ssd_state(self, slot, req):
        logits = prefill(self, slot, req)
        if req.prefix is not None:
            batcher._clear_recurrent(batcher._slot_view(self.caches, slot))
        return logits
    monkeypatch.setattr(batcher.ContinuousBatcher, "_prefill_row",
                        no_ssd_state)
    out = small_run()
    assert not out["correct"]
    assert out["checks"]["value_gap"]["value"] > \
        out["checks"]["value_gap"]["limit"]


def test_control_fails_the_check_and_the_program_passes():
    torch.set_num_threads(1)
    limits = cell.merge(manifest.config("granite4h_small"),
                        SMALL["config"])["limits"]
    out = gh.control(NAME, SEED, 2.5, overrides=SMALL, device="cpu")
    assert out["rows"] > 0
    assert out["program"]["logit_gap"] <= limits["logit_gap"]
    assert out["program"]["value_gap"] <= limits["value_gap"]
    assert out["control_logit_gap"] > limits["logit_gap"]
    assert out["control_value_gap"] > limits["value_gap"]


def test_prompts_are_the_same_work_for_every_seed():
    cfg = manifest.config("granite4h_small")
    lens = [len(gh.prompt_of(cfg, 100352, dict(uid=u, seed=s)))
            for s in (1, 2 ** 31 + 5) for u in range(8)]
    assert lens[:8] == lens[8:] == [1024, 2048, 3072, 4096] * 2
    a = gh.prompt_of(cfg, 100352, dict(uid=0, seed=1))
    assert not (a == gh.prompt_of(cfg, 100352, dict(uid=0, seed=2))).all()


@pytest.mark.parametrize("chunk", [1, 4, 11])
def test_reference_is_plain_and_stays_on_its_weights(chunk):
    """The reference draws a layer again from (seed, layer) alone, and
    its SSD from a zero state agrees with the recurrence step by step."""
    from mcts_bench.reference import granite_hybrid as ref

    dims = gh.dims_of(gh.model_config(cell.merge(
        manifest.config("granite4h_small"), SMALL["config"])))
    a = ref.draw_layer(dims, 3, 2, "cpu")
    b = ref.draw_layer(dims, 3, 2, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    g = torch.Generator().manual_seed(0)
    S, H, P, N = 11, 2, 3, 4
    x, B, C = (torch.randn(S, H, P, generator=g), torch.randn(S, N, generator=g),
               torch.randn(S, N, generator=g))
    dt, A = torch.rand(S, H, generator=g), -torch.rand(H, generator=g)
    h, want = torch.zeros(H, P, N), []
    for t in range(S):
        h = h * torch.exp(dt[t] * A)[:, None, None] + \
            (dt[t][:, None, None] * x[t][..., None]) * B[t]
        want.append(h @ C[t])
    got = ref.ssd(x, dt, A, B, C, chunk=chunk)
    torch.testing.assert_close(got, torch.stack(want), atol=1e-5, rtol=1e-5)
