"""One run of one cell: set-up, warm-up, the measured window, the drain,
the check against the reference, and the metrics.

`run()` is the whole of a run but the look for a card, which run.py
makes first; the tests call it on the CPU at small sizes.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import os
import resource
import time

from mcts_bench import check, manifest
from mcts_bench.loop import ClosedLoop
from mcts_bench.traffic.generator import Searches

KERNELS = ("uct_select", "uct_backup")   # the tree kernels; never flash
DRAIN_S = 60.0


def merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and \
            isinstance(out.get(k), dict) else v
    return out


def stats_of(client) -> dict:
    return dataclasses.asdict(client.stats)


def stats_delta(a: dict, b: dict) -> dict:
    out = {}
    for k, v in b.items():
        if isinstance(v, dict):
            out[k] = {w: n - a[k].get(w, 0) for w, n in v.items()
                      if n - a[k].get(w, 0)}
        else:
            out[k] = v - a[k]
    return out


def registry_delta(client, before: dict) -> dict:
    now = {} if client.registry is None else client.registry.snapshot()
    out = {}
    for name, series in now.items():
        old = before.get(name, {})
        out[name] = {k: v - old.get(k, 0) for k, v in series.items()}
    return out


class Context:
    """What a metric's reader reads."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def counter(self, name: str) -> float:
        """A counter's growth over the window, summed over its labels."""
        series = self.registry.get(name, {})
        return float(sum(v for k, v in series.items()
                         if k == name or k.startswith(name + "{")))

    def kernel_times(self, kernel: str) -> list:
        """Device seconds of each launch of a kernel in the profiled
        slice."""
        if self.slice is None:
            return []
        return [(b - a) / 1e6 for name, a, b in self.slice["launches"]
                if kernel in name]


def host_use() -> dict:
    """The process's own CPU seconds (user, system) and page faults (minor,
    major) so far, for the info line: a window's host time split by
    kind."""
    t, r = os.times(), resource.getrusage(resource.RUSAGE_SELF)
    return {"user_s": t.user, "sys_s": t.system,
            "minflt": r.ru_minflt, "majflt": r.ru_majflt}


def _record_selections(client, out: list):
    """Keep every selection the program reads back (the phase path's
    sel_to_host), for the kernels' byte counts; returns the undo."""
    pools = list(client.core.pools.values())
    undo = []
    for pool in pools:
        ex = pool.exec
        orig = ex.sel_to_host

        def keep(sel, _orig=orig):
            host = _orig(sel)
            out.append(host)
            return host
        ex.sel_to_host = keep
        undo.append(ex)
    return lambda: [ex.__dict__.pop("sel_to_host", None) for ex in undo]


def measure(name: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda", t_start: float = None,
            overrides: dict = None) -> Context:
    """Set-up, warm-up, the window and the drain; the program is closed
    and its memory freed on return.  What the run saw, for the check and
    the metrics."""
    t_start = time.perf_counter() if t_start is None else t_start
    marks = [("imports", time.perf_counter())]
    import torch

    cell = manifest.workload(name)
    config = manifest.config(cell["config"])
    if overrides:
        cell = merge(cell, overrides.get("cell", {}))
        config = merge(config, overrides.get("config", {}))
    on_card = torch.device(device).type == "cuda"
    if on_card:
        from repro_torch.kernels import build

        build.build_all(KERNELS)
        torch.cuda.reset_peak_memory_stats()
    marks.append(("kernels", time.perf_counter()))
    system = manifest.system(config["system"]).System(
        config, seed, device, trace)
    client = system.client
    marks.append(("system", time.perf_counter()))
    loop = ClosedLoop(system, Searches(cell["searches"], seed),
                      cell["loop"]["clients"])
    profiling = trace and on_card
    if profiling:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            pass          # the profiler's first start is slow: not inside
    from repro_torch.core import fused

    captures = [fused.captures]
    loop.start()
    loop.warm(cell["warm_ticks"])
    captures.append(fused.captures)
    if on_card:
        torch.cuda.synchronize()
    marks.append(("warm", time.perf_counter()))
    s0 = stats_of(client)
    r0 = {} if client.registry is None else client.registry.snapshot()

    sl = {"slice": None, "selections": None}
    hook = None
    if profiling:
        from mcts_bench.profile import Slice

        sl_obj = Slice(client.tracer)
        sels: list = []
        state = {"on": False, "undo": None}
        replays = config["server"].get("supersteps_per_dispatch", 1) > 1
        begin_at = time.perf_counter() + seconds - cell["profile_seconds"]

        def hook(t, last):
            if not state["on"] and t >= begin_at and not last:
                if not replays:
                    state["undo"] = _record_selections(client, sels)
                sl_obj.start()
                state["on"] = True
            if last and state["on"]:
                sl["slice"] = sl_obj.stop()
                if state["undo"]:
                    state["undo"]()
                    sl["selections"] = sels
    cpu_t0, use0 = time.process_time(), host_use()
    loop.window(seconds, hook)
    cpu_share = (time.process_time() - cpu_t0) / (loop.t1 - loop.t0)
    use = {k: v - use0[k] for k, v in host_use().items()}
    captures.append(fused.captures)
    s1 = stats_of(client)
    reg = registry_delta(client, r0)
    loop.drain(DRAIN_S)
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    kind = torch.cuda.get_device_name() if on_card else "cpu"
    system.close()
    client = loop.client = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return Context(name=name, seed=seed, trace=trace, system=system,
                   loop=loop, cell=cell, config=config,
                   setup_s=loop.t0 - t_start, window_s=loop.t1 - loop.t0,
                   stats=stats_delta(s0, s1), registry=reg, peak=peak,
                   kind=kind, on_card=on_card, captures=captures,
                   cpu_share=cpu_share, host_use=use,
                   setup_parts={b[0]: b[1] - a[1] for a, b in zip(
                       [("", t_start)] + marks, marks)}, **sl)


def run(name: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: float = None,
        overrides: dict = None) -> dict:
    """One run: `measure`, then the check against the reference and the
    metrics, as the result's dict (an "info" entry holds what else the run
    saw; run.py prints it apart)."""
    ctx = measure(name, seed, seconds, trace, device, t_start, overrides)
    loop, st = ctx.loop, ctx.stats
    t_ref = time.perf_counter()
    sample_info: dict = {}
    checks = check.compare(ctx.system, loop, ctx.config,
                           ctx.cell["check_searches"], seed, sample_info)
    t_ref = time.perf_counter() - t_ref
    e2e, layer = manifest.cell_metrics(manifest.benchmark(), name)
    metrics = {}
    for m in (layer if trace else e2e):
        value = manifest.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if ctx.on_card else "cpu",
                   "kind": ctx.kind, "count": 1,
                   "memory_peak_bytes": ctx.peak}
    out = {"correct": check.passed(checks),
           "attempted": len(loop.asked()),
           "failed": checks["moves_never_committed"]["value"],
           "metrics": metrics, "device": device_info}
    s = ctx.slice
    if s is not None:
        device_info.update(busy_s=s["busy_s"], window_s=s["window_s"])
        out["breakdown"] = {
            "device_ops": [[n[:100], v] for n, v in s["device_ops"][:10]],
            "idle_gaps": [[n, v] for n, v in s["idle_gaps"][:10]]}
    cap = ctx.captures
    out["info"] = {
        "searches": len(loop.searches), "window_s": ctx.window_s,
        "drain_s": loop.t2 - loop.t1, "reference_s": t_ref,
        **sample_info,
        "ticks": st["ticks"], "supersteps": st["supersteps"],
        "captures_warm_window": [cap[1] - cap[0], cap[2] - cap[1]],
        "fused_dispatches": st["fused_dispatches"],
        "setup_parts": ctx.setup_parts,
        "cpu_share": ctx.cpu_share,
        "window_host_use": ctx.host_use,
        "host_s": {k: st[k] for k in (
            "t_intree", "t_host", "t_expand", "t_sim", "t_fused_submit",
            "t_fused_collect", "t_fused_finish")},
        "idle_by_span": s["idle_by_span"][:12] if s else None}
    out["checks"] = checks
    return out
