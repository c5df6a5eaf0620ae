"""Quickstart: Tree-Parallel MCTS with the accelerated in-tree operations
(the port of examples/quickstart.py).

Builds the paper's system (Fig. 2) on a deterministic toy environment:
p parallel workers, UCT statistics on the device (the hand-written CUDA
kernels on the card; ``--device cpu`` runs the plain torch ``faithful``
executor, the same trees bit for bit), environment states in the host
State Table, BSP supersteps, one full MCTS step with Tree Flush.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

import argparse

from repro_torch.core import RolloutBackend, TreeConfig, TreeParallelMCTS
from repro_torch.envs import BanditTreeEnv
from repro_torch.examples import default_executor, device_flag


def run(device="cuda") -> list:
    """Five MCTS steps; prints a line a step and returns each step's
    (action, reward, supersteps)."""
    env = BanditTreeEnv(fanout=6, terminal_depth=12)
    cfg = TreeConfig(
        X=1024,          # node budget per MCTS step (tree-flush boundary)
        F=6,             # fanout = action-space size
        D=9,             # tree height limit
        vl_mode="wu",    # WU-UCT visit-count virtual loss (paper default)
    )
    sim = RolloutBackend(env, max_steps=32, seed=0)

    mcts = TreeParallelMCTS(cfg, env, sim, p=16,
                            executor=default_executor(device),
                            device=device)
    total = 0.0
    steps = []
    for step in range(5):
        action, reward, terminal = mcts.run_step(max_supersteps=30)
        total += reward
        s = mcts.stats
        steps.append((action, reward, s.supersteps))
        print(f"step {step}: action={action} reward={reward:+.3f} "
              f"supersteps={s.supersteps} "
              f"intree={s.t_intree:.3f}s sim={s.t_sim:.3f}s")
        if terminal:
            break
    print(f"total reward: {total:+.3f}")
    return steps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    device_flag(ap)
    args = ap.parse_args(argv)
    return run(args.device)


if __name__ == "__main__":
    main()
