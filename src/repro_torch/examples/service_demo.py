"""Multi-tree search service demo: many users, one scheduler (the port of
examples/service_demo.py, on the card unless --device cpu).

Default mode queues 12 search requests (mixed budgets, some multi-move)
over a 4-slot tree arena: each superstep advances every occupied slot
through one Selection / Insertion / Simulation / BackUp round in a
single device program per phase, with all slots' simulation states fused
into one backend batch.  Completed searches are evicted and the freed
slot is immediately refilled from the queue; once the queue drains,
occupancy decays and the scheduler gathers the active slots into a
dense, device-resident sub-arena (watch the per-superstep decision
trace).

--client switches to the SearchClient handle API — the serving surface
the paper's narrow CPU<->accelerator interface maps to.  Requests carry
THREE different TreeConfig shape classes and are routed into per-config
arena pools by the global scheduler under --policy:

  round-robin           one pool per tick, rotating (the compat default)
  weighted-queue-depth  every pool with work advances each tick, deepest
                        backlog first, admission caps proportional to
                        queue-depth share — and the tick's Simulation
                        rows from ALL pools fuse into ONE evaluate()
  deadline-aware        the pool holding the nearest deadline goes first

The client mode streams: each handle's moves() generator yields per-move
action/visit-distribution events as the reroots commit (iterating IS
serving — no drain-to-completion), one request carries a deadline it
cannot meet (watch it come back "evicted"), and one is cancelled
mid-flight.  Cold pools retire after --retire-after idle ticks (their
arena is freed; watch the pool summary) and resurrect on demand.

--overlap (client mode) turns on pipelined supersteps: each pool's
slots are split into --gangs gangs and the superstep is double-buffered
— gang A's host half (expansion + simulation IPC) runs while gang B's
device in-tree phases (select -> insert) are already queued on the
card's stream.  Results are bit-identical to lock-step; the summary
prints the host-wait / device-wait / overlapped pipeline split.

--frontend keeps the pre-handle ServiceFrontend adapter path.

Observability (client mode): --trace-out records every superstep phase
(select / expand / simulate / backup / compact-gather / compact-scatter)
and request lifecycle (submit -> admit -> move commits -> result /
cancel / evict) on per-pool timelines and writes Chrome-trace JSON;
--metrics prints the Prometheus text snapshot (queue depths, smoothed
load, admission waits, fused-batch sizes, evictions, expirations).

To view a trace: open https://ui.perfetto.dev in a browser, click
"Open trace file" and pick trace.json (chrome://tracing also works).
Tracks are one per arena pool plus the scheduler; zoom into any
"superstep" span to see the select/expand/simulate/backup phase split —
the Fig. 8-style breakdown the paper's CPU/FPGA numbers rest on.

--executor picks the in-tree executor: cuda (the hand-written kernels,
the default on the card) or faithful (plain torch, the default under
--device cpu); both give the same results bit for bit.

  PYTHONPATH=src python -m repro_torch.examples.service_demo
  PYTHONPATH=src python -m repro_torch.examples.service_demo \
      --executor faithful
  PYTHONPATH=src python -m repro_torch.examples.service_demo --frontend
  PYTHONPATH=src python -m repro_torch.examples.service_demo --client
  PYTHONPATH=src python -m repro_torch.examples.service_demo --client \
      --policy weighted-queue-depth --trace-out trace.json --metrics
  PYTHONPATH=src python -m repro_torch.examples.service_demo --client \
      --overlap --expansion pool --gangs 2
  PYTHONPATH=src python -m repro_torch.examples.service_demo --device cpu
"""

import argparse
import time

import numpy as np

from repro_torch.core import TreeConfig
from repro_torch.envs import BanditTreeEnv, BanditValueBackend
from repro_torch.examples import default_executor, device_flag
from repro_torch.service import (
    POLICY_NAMES, SearchClient, SearchRequest, SearchService,
    ServiceFrontend,
)

CFGS = (TreeConfig(X=512, F=6, D=8),    # deep, big arena
        TreeConfig(X=256, F=6, D=6),    # mid
        TreeConfig(X=128, F=6, D=4))    # shallow, latency-lean


def run_client(args):
    """SearchClient handle API: opaque handles, streamed moves, policies,
    deadlines, cancellation and cold-pool retirement."""
    env = BanditTreeEnv(fanout=6, terminal_depth=12)
    # overlap mode double-buffers gangs, which is incompatible with
    # compaction (slot rows must stay put while a gang is in flight)
    compact = 0.0 if args.overlap else 0.5
    client = SearchClient(
        env, BanditValueBackend(), G=4, p=16,
        executor=args.executor, expansion=args.expansion,
        policy=args.policy, retire_after_ticks=args.retire_after,
        compact_threshold=compact,
        compact_exit_threshold=0.75 if compact else None,
        supersteps_per_dispatch=args.supersteps_per_dispatch,
        n_shards=args.shards,
        overlap=args.overlap, n_gangs=args.gangs,
        trace=bool(args.trace_out), metrics=args.metrics,
        device=args.device,
    )
    t_serve0 = time.perf_counter()
    handles = [client.submit(SearchRequest(
        uid=i, seed=i, budget=6 + 2 * (i % 4), moves=1 if i % 3 else 3,
        cfg=CFGS[i % len(CFGS)]), priority=i % 2)
        for i in range(10)]
    # one request that cannot make its deadline, one we cancel mid-flight
    doomed = client.submit(
        SearchRequest(uid=98, seed=98, budget=40, cfg=CFGS[0]),
        deadline_supersteps=8)
    victim = client.submit(
        SearchRequest(uid=99, seed=99, budget=6, moves=4, cfg=CFGS[1]))

    # stream one long-lived request move by move: iterating moves() polls
    # the scheduler, so every other handle advances underneath it
    streamer = next(h for h in handles if not h.uid % 3)
    print(f"streaming handle uid={streamer.uid} "
          f"({args.policy} policy, everyone else advances underneath):")
    for ev in streamer.moves():
        print(f"  move {ev.move_index}: action={ev.action} "
              f"reward={ev.reward:+.3f} last={ev.last} "
              f"visits={np.asarray(ev.visit_counts).tolist()}")
        if ev.move_index == 1 and not victim.done():
            victim.cancel()
            print(f"  (cancelled uid={victim.uid} mid-flight: "
                  f"status={victim.status()})")

    client.run_until(lambda c: all(h.done() for h in handles)
                     and doomed.done())
    t_serve = time.perf_counter() - t_serve0
    for h in sorted(handles + [doomed, victim], key=lambda h: h.uid):
        r = h.result(wait=False)
        print(f"req {h.uid:2d}: status={h.status():9s} "
              f"actions={r.actions} supersteps={r.supersteps}")

    # drive a few idle ticks against a late request so cold pools retire
    late = client.submit(SearchRequest(uid=100, seed=7, budget=30,
                                       cfg=CFGS[0]))
    late.result()
    print("\npools (cold ones retire after "
          f"{args.retire_after} idle ticks):")
    for ps in client.pool_summaries():
        state = "RETIRED" if ps["retired"] else f"load={ps['active']}"
        print(f"  bucket X={ps['cfg'].X} D={ps['cfg'].D}: "
              f"{ps['completed']} done in {ps['supersteps']} supersteps "
              f"[{state}, idle={ps['idle_ticks']}]")
    s = client.stats
    if args.overlap:
        # per-pool pipeline split: host wait (expansion/sim IPC) vs
        # device wait (staged in-tree readback) vs overlapped wall time
        wall = host = dev = 0.0
        for pool in client.core.pools.values():
            wall += pool._ov_wall
            host += pool._ov_wait_host
            dev += pool._ov_wait_dev
        hid = max(wall - host - dev, 0.0)
        print(f"\noverlap pipeline ({args.gangs} gangs): "
              f"{t_serve:.3f}s serving wall; per-tick split "
              f"host-wait {host:.3f}s / device-wait {dev:.3f}s / "
              f"overlapped {hid:.3f}s "
              f"({100.0 * hid / max(wall, 1e-9):.0f}% of pipeline time "
              f"hidden behind the other gang)")
    else:
        print(f"\nserving wall time {t_serve:.3f}s "
              f"(re-run with --overlap to double-buffer gangs)")
    print(f"{s.completed} results ({s.cancelled} cancelled, "
          f"{s.deadline_evictions} deadline-evicted, "
          f"{s.retirements} pool retirements) in {s.ticks} ticks; "
          f"p95 admission wait {s.wait_percentile(95)} ticks; "
          f"cross-pool fused batches: {client.core.xpool_batches} "
          f"(max {client.core.xpool_rows_max} rows vs best single-pool "
          f"{client.core.xpool_pool_rows_max})")
    if args.metrics:
        print("\nPrometheus snapshot:\n" + client.metrics())
    if args.trace_out:
        trace = client.trace_export(args.trace_out)
        print(f"\nwrote {len(trace['traceEvents'])} trace events to "
              f"{args.trace_out} ({client.tracer.dropped} dropped) — open "
              f"it at https://ui.perfetto.dev (Open trace file) or "
              f"chrome://tracing")
    client.close()


def run_frontend(args):
    """Heterogeneous-config serving through the pre-handle adapter."""
    env = BanditTreeEnv(fanout=6, terminal_depth=12)
    fe = ServiceFrontend(
        env, BanditValueBackend(), G=4, p=16,
        executor=args.executor, expansion=args.expansion,
        policy=args.policy,
        compact_threshold=0.5, compact_exit_threshold=0.75,
        supersteps_per_dispatch=args.supersteps_per_dispatch,
        device=args.device,
    )
    for i in range(12):
        fe.submit(SearchRequest(
            uid=i, seed=i, budget=6 + 2 * (i % 4), moves=1 if i % 3 else 2,
            cfg=CFGS[i % len(CFGS)],        # mixed shape classes
        ))
    while fe.superstep():
        pool = fe.pools[fe.last_key]
        d = pool.last_decision
        mode = (f"session[{d['session']}] sub-arena G={d['G_exec']}"
                if d["compacted"] else "masked full arena")
        print(f"tick {fe.stats.ticks:3d}: "
              f"bucket X={pool.cfg.X} D={pool.cfg.D} "
              f"{pool.load()}/{pool.G} slots active — {mode}")
    for r in sorted(fe.completed, key=lambda r: r.uid):
        print(f"req {r.uid:2d}: actions={r.actions} "
              f"reward={sum(r.rewards):+.3f} supersteps={r.supersteps}")
    print()
    for ps in fe.pool_summaries():
        print(f"bucket {ps['bucket'][:3]}: {ps['completed']} done in "
              f"{ps['supersteps']} supersteps; sessions: "
              f"{ps['session_gathers']} gathers / "
              f"{ps['session_reuses']} resident reuses / "
              f"{ps['session_scatters']} scatters")
    s = fe.stats
    print(f"\n{s.completed} searches over {len(fe.pools)} config buckets "
          f"in {s.supersteps} supersteps on executor={args.executor}")
    fe.close()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--executor", choices=("faithful", "cuda"),
                    default=None,
                    help="in-tree executor: the plain torch arena "
                         "(faithful, the default under --device cpu) or "
                         "the hand-written [G]-grid CUDA kernels (cuda, "
                         "the default on the card)")
    ap.add_argument("--expansion", choices=("loop", "vector", "pool"),
                    default="vector",
                    help="host-expansion engine: per-worker env.step loop, "
                         "one flattened step_batch across all slots "
                         "(vector), or a process pool of scalar workers")
    ap.add_argument("--policy", choices=POLICY_NAMES, default="round-robin",
                    help="global schedule policy (client/frontend modes): "
                         "which pools advance each tick and how buckets "
                         "admit; weighted-queue-depth gang ticks fuse ONE "
                         "evaluate() batch across every pool")
    ap.add_argument("--supersteps-per-dispatch", type=int, default=1,
                    metavar="K",
                    help="fused K-superstep device dispatch: run up to K "
                         "supersteps per compiled program, escaping only "
                         "at move commits or host-bound expansions.  K>1 "
                         "needs device-evaluable env + sim twins (the "
                         "bandit env here has them; host-only backends "
                         "silently keep the K=1 phase-by-phase path)")
    ap.add_argument("--overlap", action="store_true",
                    help="client mode: pipelined supersteps — split each "
                         "pool's slots into --gangs gangs and double-"
                         "buffer the superstep, so one gang's host "
                         "expansion/simulation runs while the next gang's "
                         "device in-tree phases are already dispatched "
                         "(results stay bit-identical; disables "
                         "compaction, which needs slot rows to stay put)")
    ap.add_argument("--gangs", type=int, default=2, metavar="N",
                    help="client mode: gangs per pool for --overlap "
                         "(2 = classic double buffering)")
    ap.add_argument("--shards", type=int, default=1, metavar="D",
                    help="client mode: partition each bucket's G slots "
                         "across D per-device shard arenas (least-loaded "
                         "placement; results bit-identical to D=1).  Shard "
                         "d lives on cuda:(d %% device_count)")
    ap.add_argument("--retire-after", type=int, default=12, metavar="TICKS",
                    help="client mode: idle ticks before a cold pool "
                         "releases its arena (resurrected on demand)")
    ap.add_argument("--trace-out", metavar="PATH", default=None,
                    help="client mode: record phase + request-lifecycle "
                         "spans and write Chrome-trace JSON here (open at "
                         "ui.perfetto.dev)")
    ap.add_argument("--metrics", action="store_true",
                    help="client mode: print the Prometheus exposition "
                         "snapshot of the scheduler/pool telemetry")
    ap.add_argument("--client", action="store_true",
                    help="serve through the SearchClient handle API: "
                         "streamed moves(), priorities, deadlines, "
                         "cancellation, cold-pool retirement")
    ap.add_argument("--frontend", action="store_true",
                    help="serve a heterogeneous-config mix through the "
                         "pre-handle ServiceFrontend adapter")
    device_flag(ap)
    args = ap.parse_args(argv)
    args.executor = args.executor or default_executor(args.device)
    if args.client:
        return run_client(args)
    if args.frontend:
        return run_frontend(args)

    env = BanditTreeEnv(fanout=6, terminal_depth=12)
    cfg = TreeConfig(X=512, F=6, D=8)
    svc = SearchService(
        cfg, env, BanditValueBackend(),
        G=4,                     # concurrent tree slots
        p=16,                    # workers (simulations) per tree per superstep
        executor=args.executor,  # unified stack ("reference" = numpy oracle)
        compact_threshold=0.5,   # opt-in: gather active slots when <= half
        expansion=args.expansion,  # batched host expansion (core.expand)
        supersteps_per_dispatch=args.supersteps_per_dispatch,
        device=args.device,
    )                            # the arena is occupied (see pool docs)

    for i in range(12):
        svc.submit(SearchRequest(
            uid=i,
            seed=i,
            budget=6 + 2 * (i % 4),        # mixed budgets: slots drain
            moves=1 if i % 3 else 2,       # unevenly, so the tail of the
        ))                                 # run exercises compaction


    # drive dispatch-by-dispatch to trace the occupancy/compaction choice
    # (a fused dispatch runs up to K supersteps per compiled program)
    K = args.supersteps_per_dispatch
    while (svc.fused_dispatch() if K > 1 else svc.superstep()):
        d = svc.last_decision
        mode = (f"session[{d['session']}] sub-arena G={d['G_exec']}"
                if d["compacted"] else "masked full arena")
        print(f"superstep {svc.stats.supersteps:3d}: "
              f"{svc.load()}/{d['G']} slots active "
              f"(occupancy {d['occupancy']:.2f}) — {mode}")

    done = svc.completed
    for r in sorted(done, key=lambda r: r.uid):
        dist = r.visit_counts[-1]
        print(f"req {r.uid:2d}: actions={r.actions} "
              f"reward={sum(r.rewards):+.3f} supersteps={r.supersteps} "
              f"last visit dist={np.asarray(dist).tolist()}")
    s = svc.stats
    print(f"\n{s.completed} searches in {s.supersteps} supersteps "
          f"on executor={args.executor} "
          f"({s.compacted_supersteps} compacted, "
          f"avg occupancy {s.occupancy_sum / max(s.supersteps, 1):.2f}); "
          f"fused sim batches: {s.sim_batches} "
          f"(max {s.max_fused_rows} states/batch); "
          f"intree={s.t_intree:.3f}s host={s.t_host:.3f}s sim={s.t_sim:.3f}s")


if __name__ == "__main__":
    main()
