"""Run one cell of the benchmark once and print its result.

    python3 mcts_bench/run.py --workload <cell> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

From the root of a checkout.  The cell's file (mcts_bench/workloads/
<cell>.json) names its configuration (mcts_bench/configs/), the
configuration its system (mcts_bench/systems/); the metrics are the
cell's entries in BENCHMARK.json, each read by mcts_bench/metrics/
<metric>.py.  The program measured is repro_torch (src/repro_torch) on
one CUDA card.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics (with --trace 0 the end-to-end metrics, with --trace 1
the per-layer ones), device, with --trace 1 breakdown, and last the
numbers compared with their limits, which also end standard error.
Without a card, or with fewer cards than the cell asks for, or with JAX
or the JAX package loaded at the end, it prints no result and exits 2.

A cell's file may name environment variables for the process to start
with ("host_env"; the C library reads some only at start): the process
then runs itself again with them set, and setup_s counts from the first
start.  The cells set glibc's malloc thresholds there: left to glibc,
whether the program's large host buffers (a tree snapshot at each move
commit, a fresh tree at each admission) are mapped anew, and fault in
page by page, depends on the process's own allocation history, and the
same run then took 1x or 2.5x the time from one process to the next.
"""

import json
import os
import re
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def host_env(argv: list) -> dict:
    """The cell's "host_env", or nothing where the cell is not found."""
    try:
        name = argv[argv.index("--workload") + 1]
    except (ValueError, IndexError):
        return {}
    if not re.match(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$", name):
        return {}
    try:
        with open(os.path.join(ROOT, "mcts_bench", "workloads",
                               name + ".json")) as f:
            return dict(json.load(f).get("host_env", {}))
    except (OSError, ValueError):
        return {}


WANT = host_env(sys.argv)
if any(os.environ.get(k) != v for k, v in WANT.items()):
    os.environ.update(WANT)
    os.environ["MCTS_BENCH_STARTED"] = repr(time.time())
    os.execv(sys.executable, [sys.executable] + sys.argv)
if "MCTS_BENCH_STARTED" in os.environ:
    T_START -= time.time() - float(os.environ.pop("MCTS_BENCH_STARTED"))

import argparse  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def fail(msg: str) -> None:
    print(msg, file=sys.stderr)
    sys.exit(2)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    # a library that could load JAX by itself is told not to
    os.environ.setdefault("USE_FLAX", "0")

    import torch

    from mcts_bench import cell, check, manifest

    chips = next((w["chips"] for w in manifest.benchmark()["workloads"]
                  if w["name"] == args.workload), 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        fail(f"mcts_bench: {args.workload} needs {chips} CUDA card(s); "
             f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    out = cell.run(args.workload, args.seed, args.seconds, bool(args.trace),
                   device="cuda", t_start=T_START)
    found = sorted({m.split(".")[0] for m in sys.modules}
                   & set(FORBIDDEN))
    if found:
        fail(f"mcts_bench: the run loaded {found}")
    print("info " + json.dumps(out.pop("info")), file=sys.stderr)
    for line in check.lines(out["checks"]):
        print(line, file=sys.stderr)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
