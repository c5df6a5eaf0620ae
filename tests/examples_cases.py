"""Helpers of tests/test_torch_examples*.py: run a JAX example's main()
(loaded by path, sys.argv patched; nothing in examples/ changes) and a
port example's, capturing what each prints, and the printed lines with
their timings taken out."""

import contextlib
import importlib
import importlib.util
import io
import re
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def jax_example(name: str):
    """The JAX package's examples/<name>.py as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def captured(fn, *args, **kw) -> str:
    """What fn(*args, **kw) prints."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args, **kw)
    return buf.getvalue()


def run_jax(name: str, argv: list) -> str:
    """The JAX example's main() under `argv`; what it prints."""
    mod = jax_example(name)
    old, sys.argv = sys.argv, [f"{name}.py"] + list(argv)
    try:
        return captured(mod.main)
    finally:
        sys.argv = old


def run_port(name: str, argv: list) -> str:
    """The port's twin's main(argv + --device cpu); what it prints."""
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    return captured(mod.main, list(argv) + ["--device", "cpu"])


def untimed(text: str) -> list:
    """The printed lines with every seconds field (``t_*`` timings, wall
    times) and the overlap split's percentage replaced by a mark."""
    text = re.sub(r"\d+\.\d+s\b", "<s>", text)
    text = re.sub(r"\(\d+% of pipeline", "(<%> of pipeline", text)
    return text.splitlines()


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each example test runs torch on one CPU thread (restored after):
    the examples' many small tensor ops beside a pipeline thread or the
    other test workers' processes oversubscribe the cores otherwise (the
    overlapped-gangs demo took 10x as long)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
