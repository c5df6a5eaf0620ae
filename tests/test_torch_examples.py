"""The port's examples (src/repro_torch/examples/) against the JAX
package's (examples/) on the CPU, on the same flags: every printed line
identical with the seconds fields taken out.  quickstart (RolloutBackend
over the bandit tree, the port's faithful executor under --device cpu)
and service_demo in its SearchService, SearchClient, ServiceFrontend and
overlapped-gangs modes at the originals' sizes.  The Gomoku, LM and
training examples are in tests/test_torch_examples_lm.py."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from examples_cases import (  # noqa: E402,F401
    one_torch_thread, run_jax, run_port, untimed)

from repro_torch.examples import default_executor  # noqa: E402


def test_quickstart_matches_jax():
    want = untimed(run_jax("quickstart", []))
    got = untimed(run_port("quickstart", []))
    assert len(want) == 6 and want[-1].startswith("total reward")
    assert got == want


def test_quickstart_returns_its_steps():
    from examples_cases import captured
    from repro_torch.examples import quickstart
    out = {}
    text = captured(lambda: out.setdefault("s", quickstart.run("cpu")))
    assert len(out["s"]) == 5
    for (a, r, n), ln in zip(out["s"], text.splitlines()):
        assert f"action={a} reward={r:+.3f} supersteps={n}" in ln


@pytest.mark.parametrize("argv", [
    [],
    ["--client"],
    ["--frontend"],
    ["--client", "--overlap", "--gangs", "2", "--expansion", "vector"],
], ids=["service", "client", "frontend", "client-overlap"])
def test_service_demo_matches_jax(argv):
    want = untimed(run_jax("service_demo", argv))
    got = untimed(run_port("service_demo", argv))
    assert any(ln.startswith("req ") for ln in want)
    assert got == want


def test_default_executor_by_device():
    assert default_executor("cpu") == "faithful"
    assert default_executor("cuda") == "cuda"
    assert default_executor("cuda:0") == "cuda"


def test_examples_default_to_the_card():
    """With no card, an example run without --device raises rather than
    falling back to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from repro_torch.examples import quickstart, service_demo
    with pytest.raises(RuntimeError, match="CUDA"):
        quickstart.main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        service_demo.main(["--client"])
