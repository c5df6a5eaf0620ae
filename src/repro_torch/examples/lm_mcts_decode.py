"""Token-level MCTS decoding with an LM simulation backend, fully served
(the port of examples/lm_mcts_decode.py).

The paper's Gomoku benchmark replaces rollouts with DNN inference; this
example pushes that to its modern conclusion: the simulation backend is a
language model's serve path, and MCTS plans over next-token actions —
the tree machinery (UCT on the device, ST on host) is untouched.

The workload runs through the production stack end to end: the decode is
one multi-move SearchRequest on a SearchClient at priority class
"interactive", tokens stream out of SearchHandle.moves() as each reroot
commits, and simulation batches flow through repro_torch.sim — a
SimServer microbatches the tree's leaf rows, and LMContinuationBackend
scores each row's greedy continuation by mean token log-prob, decoding ALL
rows concurrently through one ContinuousBatcher pool
(serving/batcher.py).  On the card the tree runs on the hand-written
kernels and the LM's prefills on the flash kernel.

  PYTHONPATH=src python -m repro_torch.examples.lm_mcts_decode --tokens 6
"""

import argparse

import torch

from repro_torch import configs
from repro_torch.core import TreeConfig
from repro_torch.examples import default_executor, device_flag
from repro_torch.models import lm
from repro_torch.service import SearchClient, SearchRequest
from repro_torch.sim import LMContinuationBackend, LMTreeEnv, SimServer


def decode(cfg, params, tokens, p, pool_size, device="cuda",
           executor=None) -> list:
    """Plan `tokens` tokens by MCTS over the LM with `params` (on
    `device`); prints each streamed token and returns the sequence."""
    env = LMTreeEnv(cfg, params)
    sim = SimServer(LMContinuationBackend(env, pool_size=pool_size),
                    max_batch=p, default_priority="interactive")
    tree_cfg = TreeConfig(X=96, F=env.F, D=4)

    with SearchClient(env, sim_backend=sim, G=1, p=p,
                      executor=executor or default_executor(device),
                      default_cfg=tree_cfg, device=device) as client:
        handle = client.submit(SearchRequest(
            uid=0, seed=0, budget=8, moves=tokens))
        state = env.initial_state(0)
        seq = [int(state[1])]
        for ev in handle.moves():
            state, _, term = env.step(state, ev.action)
            seq.append(int(state[int(state[0])]))
            print(f"token {ev.move_index}: planned action {ev.action}; "
                  f"sequence so far {seq}")
            if term:
                break
    print("decoded:", seq)
    return seq


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--tokens", type=int, default=6)
    ap.add_argument("--p", type=int, default=4)
    ap.add_argument("--pool-size", type=int, default=8,
                    help="ContinuousBatcher decode pool (LM microbatch)")
    device_flag(ap)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = configs.get_config(args.arch, smoke=True)
    gen = torch.Generator(device=args.device).manual_seed(0)
    params = lm.init_params(cfg, gen, args.device)
    return decode(cfg, params, args.tokens, args.p, args.pool_size,
                  args.device)


if __name__ == "__main__":
    main()
