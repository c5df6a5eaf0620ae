"""BENCHMARK.json and every file it finds by name: the contract's shapes,
characters and cross references, and the command's imports."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(REPO), str(REPO / "src")]

from mcts_bench import manifest  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = manifest.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert BENCH["paths"] == ["mcts_bench"]
    assert 1 <= len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert one_line(word) and not word.startswith("/") and ".." not in word
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits the driver's 43,200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}),
])
def test_entries_and_names(section, keys):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert set(e) - {"workloads"} == keys, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "source", "layer"):
            if k in e:
                assert one_line(e[k]), (e["name"], k)
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")


def test_metrics_and_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            e, _ = manifest.cell_metrics(BENCH, cell)
            assert m["moves"] in {x["name"] for x in e}, (m["name"], cell)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    perf = (REPO / "PERF.md").read_text()
    for layer in layers:
        assert f"**{layer}**" in perf, layer


def test_every_cell_reports_enough():
    for cell in CELLS:
        e2e, layer = manifest.cell_metrics(BENCH, cell)
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        assert layer, cell


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert entry["chips"] == 1
    w = manifest.workload(cell)
    assert (w["name"], w["config"], w["traffic"], w["why"]) == (
        cell, entry["config"], entry["traffic"], entry["why"])
    assert NAME.match(entry["traffic"])
    assert w["loop"]["kind"] == "closed"
    cfg = manifest.config(w["config"])
    assert w["loop"]["clients"] == 2 * cfg["server"]["G"]
    assert 0 < w["check_searches"]
    pairs = [(x["config"], x["traffic"]) for x in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_files(entry):
    path = REPO / entry["file"]
    assert path.is_relative_to(REPO / "mcts_bench")
    cfg = json.loads(path.read_text())
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"] == []
    assert len(entry["reduced"]) <= 16
    assert entry["name"] in {w["config"] for w in BENCH["workloads"]}
    assert manifest.system(cfg["system"]).System
    assert cfg["assumed"]
    for k, v in cfg["limits"].items():
        assert v is not None, k


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"]
                                    + BENCH["per_layer"]])
def test_each_metric_has_a_reader(metric):
    assert callable(manifest.reader(metric))


def test_files_under_paths_are_named_from_name_characters():
    for path in (REPO / "mcts_bench").rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(REPO).as_posix()
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", rel), rel


def test_the_command_loads_neither_jax_nor_the_jax_package():
    """A run's whole import chain (a small run on the CPU, every system
    and reader loaded) leaves no module whose top-level name is jax,
    jaxlib, flax or repro; the names are compared whole (repro_torch is
    the port)."""
    code = """
import sys
sys.path[:0] = [{repo!r}, {src!r}]
import torch
torch.set_num_threads(1)
from mcts_bench import cell, control, manifest, profile
for name in ("pong.blitz", "gomoku.book_repeat"):
    cell.run(name, 7, 0.5, True, device="cpu", overrides=dict(
        config=dict(tree=dict(X=600), server=dict(G=2, p=4)),
        cell=dict(loop=dict(clients=4), warm_ticks=2, check_searches=1,
                  searches=dict(budget=[2, 4], moves=[1, 2]))))
for m in manifest.benchmark()["end_to_end"] + manifest.benchmark()["per_layer"]:
    manifest.reader(m["name"])
print(sorted({{m.split(".")[0] for m in sys.modules}}))
""".format(repo=str(REPO), src=str(REPO / "src"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "repro"}


def test_run_without_a_card_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: run.py would run the cell")
    out = subprocess.run(
        [sys.executable, "mcts_bench/run.py", "--workload", "pong.blitz",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=str(REPO))
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr
