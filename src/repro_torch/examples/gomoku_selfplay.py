"""Gomoku self-play with DNN simulation (paper benchmark b, end to end;
the port of examples/gomoku_selfplay.py).

Replicates the paper's Gomoku setup: 6x6 board, expand-all, PUCT with a
policy-value network as the Simulation phase — then closes the loop by
training the network on the self-play targets (AlphaZero-style), with
torch.autograd over leaf copies of the net's weights.

Served through the full client stack: every game is one multi-move
SearchRequest on a SearchClient, the G game slots run concurrently in
one arena, and the network runs behind the sim-serving subsystem
(repro_torch.sim) — a SimServer microbatches all slots' inference rows
into fixed-shape batches (the paper Fig. 5 batching) at priority class
"self-play", with a transposition cache in front so re-expanded
positions skip inference entirely.  On the card the tree runs on the
hand-written kernels and the net's forwards on cuDNN / cuBLAS (TF32 off).

  PYTHONPATH=src python -m repro_torch.examples.gomoku_selfplay --games 2 --p 8
"""

import argparse

import numpy as np
import torch

from repro_torch.core import TreeConfig
from repro_torch.envs import GomokuEnv
from repro_torch.envs.policy_net import (NNSimBackend, PolicyValueNet,
                                         exact_f32, init_params)
from repro_torch.examples import default_executor, device_flag
from repro_torch.service import SearchClient, SearchRequest
from repro_torch.sim import CachedSimBackend, SimServer

CFG = TreeConfig(X=384, F=36, D=5, beta=5.0, score_fn="puct",
                 leaf_mode="unexpanded", expand_all=True)


def play_games(env, params, n_games, p, G=4, budget=8, max_batch=64,
               cache_capacity=4096, uid_base=0, device="cuda", executor=None):
    """Self-play n_games concurrently through one SearchClient; returns
    (states, value targets, winners) replayed from the committed moves."""
    sim = CachedSimBackend(
        SimServer(NNSimBackend(env, params, device=device),
                  max_batch=max_batch, default_priority="self-play"),
        capacity=cache_capacity)
    client = SearchClient(env, sim_backend=sim, G=G, p=p,
                          executor=executor or default_executor(device),
                          default_cfg=CFG, alternating_signs=True,
                          device=device)
    try:
        handles = [client.submit(
            SearchRequest(uid=uid_base + g, seed=g, budget=budget,
                          moves=env.max_actions))
            for g in range(n_games)]
        results = [h.result() for h in handles]
    finally:
        client.close()
    buf_s, buf_z, winners = [], [], []
    for g, res in enumerate(results):
        s = env.initial_state(g)
        states, players = [], []
        for a in res.actions:
            states.append(s.copy())
            players.append(s[0])
            s, _, term = env.step(s, a)
            if term:
                break
        winner = s[2]
        buf_s += states
        buf_z += [0.0 if winner == 0 else (1.0 if pl == winner else -1.0)
                  for pl in players]
        winners.append(winner)
    return buf_s, buf_z, winners


def train_net(params, states, z, lr=1e-2, epochs=30, device="cuda"):
    """Plain SGD on the value MSE over (states, z); returns the new
    weights (on the CPU, the layout NNSimBackend takes) and the last
    epoch's loss before its update."""
    boards = np.stack([st[3:39].reshape(6, 6) * st[0] for st in states])
    boards = torch.as_tensor(boards, dtype=torch.float32, device=device)
    targets = torch.as_tensor(np.asarray(z, np.float32), device=device)
    net = PolicyValueNet(params).to(device)
    w = {k: v.detach().to(device).clone().requires_grad_(True)
         for k, v in params.items()}
    with exact_f32():
        for _ in range(epochs):
            v, _ = torch.func.functional_call(net, w, (boards,))
            loss = torch.mean((v - targets) ** 2)
            grads = torch.autograd.grad(loss, list(w.values()),
                                        allow_unused=True)
            with torch.no_grad():     # the policy head's grads are zero
                w = {k: (a if g is None else a - lr * g).requires_grad_(True)
                     for (k, a), g in zip(w.items(), grads)}
    return {k: a.detach().cpu() for k, a in w.items()}, float(loss.detach())


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--games", type=int, default=2)
    ap.add_argument("--p", type=int, default=8)
    ap.add_argument("--G", type=int, default=4,
                    help="concurrent game slots per self-play round")
    ap.add_argument("--max-batch", type=int, default=64,
                    help="SimServer microbatch size")
    device_flag(ap)
    return ap.parse_args(argv)


def run(args, params, executor=None) -> list:
    """The self-play loop from `params` (the net's weights, as
    policy_net.init_params returns them); returns a dict a round: its
    game's states and value targets, the winner, the weights it played
    with and the value loss of the training that followed."""
    env = GomokuEnv()
    buf_s, buf_z, rounds = [], [], []
    for rnd in range(args.games):
        states, z, winners = play_games(
            env, params, n_games=1, p=args.p, G=args.G,
            max_batch=args.max_batch, uid_base=rnd * args.G,
            device=args.device, executor=executor)
        buf_s += states
        buf_z += z
        played = params
        params, loss = train_net(params, buf_s, buf_z, device=args.device)
        rounds.append({"states": np.stack(states), "z": z,
                       "winner": winners[0], "params": played, "loss": loss})
        print(f"game {rnd}: {len(states)} moves, "
              f"winner={winners[0]:+.0f}, value-loss={loss:.4f}")
    print("self-play loop complete")
    return rounds


def main(argv=None):
    args = parse_args(argv)
    return run(args, init_params(torch.Generator().manual_seed(0)))


if __name__ == "__main__":
    main()
