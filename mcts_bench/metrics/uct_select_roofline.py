"""The Selection kernel's share of its roofline over the profiled
slice: the least time a launch's bytes and operations need
(costs/kernels.py, at the card's peaks), times the launches, over their
device time.  A launch's bytes follow the paths its workers walked: the
mean over the selections the program read back in the slice (the phase
path).  Inside a fused replay the paths cannot be seen, and every worker
is counted at depth D (costs.kernels.model_paths)."""

from mcts_bench.costs import kernels, peaks


def read(ctx):
    times = ctx.kernel_times("uct_select_kernel")
    if not times:
        return None
    tree, server = ctx.config["tree"], ctx.config["server"]
    Fp = kernels.pad_fanout(tree["F"])
    sels = ctx.selections or [
        kernels.model_paths(server["G"], server["p"], tree["D"])]
    bound = sum(peaks.bound_s(*kernels.select_cost(Fp, tree["score_fn"] == "puct", sel, tree["D"]))
                for sel in sels) / len(sels)
    return 100.0 * bound * len(times) / sum(times)
