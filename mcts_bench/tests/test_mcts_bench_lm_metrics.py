"""`lm.rows_per_admit_forward` over the registry a run reads: the
program's admission rows over its admission forwards, and None where a
program counts neither."""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(REPO), str(REPO / "src")]

from mcts_bench import manifest  # noqa: E402
from mcts_bench.cell import Context  # noqa: E402

READ = manifest.reader("lm.rows_per_admit_forward")


def test_rows_over_forwards_from_the_program_counters():
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.serving.batcher import LMCounters

    reg = MetricsRegistry()
    counters = LMCounters("cpu", reg)
    for rows in (1, 5, 4, 1, 3):     # a B=1 prefill, batched extends
        counters.admitted(rows)
    assert READ(Context(registry=reg.snapshot())) == pytest.approx(14 / 5)


@pytest.mark.parametrize("registry", [
    {},                                                  # the parent's
    {"lm_admit_forwards_total": {"lm_admit_forwards_total": 0.0},
     "lm_admit_forward_rows_total": {"lm_admit_forward_rows_total": 0.0}},
], ids=["absent", "no-admission"])
def test_none_without_admission_forwards(registry):
    assert READ(Context(registry=registry)) is None
