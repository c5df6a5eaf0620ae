"""On the card (skips elsewhere): one short run of a cell through the
command, as the benchmark's check starts it."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["pong.blitz", "gomoku.selfplay"])
def test_a_short_run_is_correct(card, cell):
    out = subprocess.run(
        [sys.executable, "mcts_bench/run.py", "--workload", cell,
         "--seed", str(2 ** 31 + 17), "--seconds", "3", "--trace", "1"],
        capture_output=True, text=True, timeout=360, cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert list(res)[-1] == "checks"
    assert out.stderr.rstrip().splitlines()[-1].startswith("check ")
