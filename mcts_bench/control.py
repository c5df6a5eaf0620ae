"""The control: the reference put in the program's place and computed one
precision below the configuration's, which the check must find wrong.

    python3 mcts_bench/control.py --workload <cell> --seeds 1 2 3 \
        [--seconds <run_seconds>]

bandit (Pong): the configuration states float32 values; the control's
values are rounded to bfloat16.  For each seed, the searches a run of
the cell checks (its first searches, as many as `check_searches`) are
worked out by the reference in both precisions, and `moves_mismatched`
counts the control's moves that differ from the float32 reference's.
Nothing here needs the card.

gomoku_net (Gomoku): the configuration states the net in float32 with
TF32 off; the control is the reference net in TF32.  For each seed, one
run of the cell on the card at its own load and length (a plain run:
its own readings are printed too), then, over the rows that run's check
reads, the gaps between the TF32 net and the float64 reference
(`value_gap`, `prior_gap`).

One JSON line a seed.  Not part of a benchmark run.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bandit_control(cell: dict, config: dict, seed: int) -> dict:
    import numpy as np

    from mcts_bench import manifest
    from mcts_bench.traffic.generator import Searches

    system = manifest.system(config["system"])
    specs = Searches(cell["searches"], seed)
    bad = total = 0
    for _ in range(cell["check_searches"]):
        spec = specs.next()
        want = system.reference_moves(config, spec, spec["moves"])
        got = system.reference_moves(config, spec, spec["moves"], "bfloat16")
        for i, (a, v) in enumerate(want):
            total += 1
            bad += not (i < len(got) and got[i][0] == a
                        and np.array_equal(got[i][1], v))
    return {"control_moves_mismatched": bad, "moves_compared": total}


def net_control(name: str, seed: int, seconds: float,
                overrides: dict = None) -> dict:
    import numpy as np

    from mcts_bench import cell, check
    from mcts_bench.reference import net as ref_net

    ctx = cell.measure(name, seed, seconds, False,
                       device="cuda" if overrides is None else "cpu",
                       overrides=overrides)
    checks = check.compare(ctx.system, ctx.loop, ctx.config,
                           ctx.cell["check_searches"], seed)
    states, _, _ = ctx.system.checked_rows()
    w = ctx.system.weights
    ref_v, ref_p = ref_net.evaluate(w, states)
    low_v, low_p = ref_net.evaluate(w, states, "tf32")
    return {"program": {k: c["value"] for k, c in checks.items()},
            "control_value_gap": float(np.abs(low_v - ref_v).max()),
            "control_prior_gap": float(np.abs(low_p - ref_p).max()),
            "rows": len(states)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from mcts_bench import manifest

    cell = manifest.workload(args.workload)
    config = manifest.config(cell["config"])
    seconds = args.seconds or manifest.benchmark()["run_seconds"]
    for seed in args.seeds:
        t0 = time.perf_counter()
        if config["system"] == "bandit":
            out = bandit_control(cell, config, seed)
        else:
            out = net_control(args.workload, seed, seconds)
        out.update(workload=args.workload, seed=seed,
                   seconds=time.perf_counter() - t0)
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
