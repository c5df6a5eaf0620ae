"""Finds every piece of the benchmark by its name.

  BENCHMARK.json (at the repository's root)  cells, metrics, bounds
  mcts_bench/workloads/<cell>.json           a cell: its configuration,
                                             loop, searches and why
  mcts_bench/configs/<config>.json           a configuration: tree, env,
                                             server, limits, assumptions
  mcts_bench/systems/<system>.py             the program and reference
                                             sides of a configuration's
                                             kind (its "system")
  mcts_bench/metrics/<metric>.py             one reader a metric

A configuration, a cell or a metric is added by adding its file and its
entry; nothing here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _name(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def benchmark() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def workload(name: str) -> dict:
    return json.loads((HERE / "workloads" / f"{_name(name)}.json").read_text())


def config(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{_name(name)}.json").read_text())


def system(kind: str):
    return importlib.import_module(f"mcts_bench.systems.{_name(kind)}")


def reader(metric: str):
    """The `read(ctx)` of metrics/<metric>.py (names may hold dots, so the
    file is loaded by its path)."""
    path = HERE / "metrics" / f"{_name(metric)}.py"
    spec = importlib.util.spec_from_file_location(
        "mcts_bench.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str) -> tuple:
    """(end-to-end, per-layer) metric entries a cell reports: those whose
    `workloads` name it, or, without the key, every cell (end-to-end) or
    every cell that reports the metric it moves (per-layer)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer
