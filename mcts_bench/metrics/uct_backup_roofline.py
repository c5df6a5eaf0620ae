"""The BackUp kernel's share of its roofline, counted as for Selection
(uct_select_roofline.py) over the same paths."""

from mcts_bench.costs import kernels, peaks


def read(ctx):
    times = ctx.kernel_times("uct_backup_kernel")
    if not times:
        return None
    tree, server = ctx.config["tree"], ctx.config["server"]
    sels = ctx.selections or [
        kernels.model_paths(server["G"], server["p"], tree["D"])]
    bound = sum(peaks.bound_s(*kernels.backup_cost(sel, tree["D"]))
                for sel in sels) / len(sels)
    return 100.0 * bound * len(times) / sum(times)
