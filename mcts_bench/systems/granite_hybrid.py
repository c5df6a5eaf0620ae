"""Token-level MCTS decoding over granite-4.0-h-small (the granite4h_small
configuration).

Program side: the port's SearchClient over LMTreeEnv (root snapshots
on, CUDA graphs of the suffix forwards up to the tree's depth and of the
decode step) and SimServer(LMContinuationBackend), the model's weights drawn on
the device from the run's seed by the reference's own draw
(reference/granite_hybrid.py), so that the reference can draw any layer
again by itself.  Each search's root is a prompt made from its seed
(``prompt_of``): fresh tokens, its length spread over the configuration's
range by the search's uid within a block, so two seeds give the same
work.  The env, the backend and the server are wrapped so that every
answer the program gave is kept: each expanded state's top tokens and
its logits at those tokens and at fixed probe ids, each simulated
state's value (in the order the trees consumed them) and the
continuation it decoded.

Reference side, in two stages, as for the Gomoku net.  The tree: the
plain oracle replays each sampled search from its prompt, stepping each
state by the program's top tokens for it and taking each simulation's
value from the program's answers for that state in turn, and must commit
the same moves with the same visit counts.  The net: for a sample of the
states both expanded and simulated (those the replays read first), the
plain float32 reference runs the state and its continuation (teacher-
forced on the program's tokens) and gives the state's last-position
logits and the continuation's mean log-prob again; the program's are
held to them within `logit_gap` and `value_gap`.  `moe_tokens_dropped`
counts the (token, expert) pairs the program's MoE layers dropped.

The control (``control``, and this module run as a script): the
reference one precision below the configuration in each part (the SSD
state carried across chunks and the router in bfloat16 where float32 is
stated, the layers' normed inputs in float8 e4m3 where bfloat16 is),
over the rows a run of the cell checks; its gaps to the float32
reference must fail the limits.  ``control(..., part="state_router")``
lowers only the SSD state and the router, for the record.

    python3 mcts_bench/systems/granite_hybrid.py \\
        --workload granite4h_small.token_mcts --seeds 1 2 3
"""

from __future__ import annotations

import os
import sys

if __name__ == "__main__":
    _ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path[:0] = [_ROOT, os.path.join(_ROOT, "src")]

import numpy as np  # noqa: E402

from mcts_bench.reference import granite_hybrid as ref  # noqa: E402
from mcts_bench.reference import search as ref_search  # noqa: E402
from mcts_bench.reference import tree as ref_tree  # noqa: E402
from mcts_bench.systems import make_client  # noqa: E402
from mcts_bench.traffic.generator import spread  # noqa: E402

PROBES = 64         # fixed vocabulary ids whose logits are kept beside the
#                     top tokens of each expanded state
# the published config.json's keys the port's configuration must match
PUBLISHED = ("hidden_size", "layer_types", "mamba_n_heads", "mamba_d_head",
             "mamba_d_state", "mamba_n_groups", "mamba_d_conv",
             "mamba_chunk_size", "mamba_expand", "num_attention_heads",
             "num_key_value_heads", "attention_multiplier",
             "num_local_experts", "num_experts_per_tok", "intermediate_size",
             "shared_intermediate_size", "embedding_multiplier",
             "residual_multiplier", "logits_scaling", "rms_norm_eps",
             "vocab_size", "num_hidden_layers", "tie_word_embeddings")


def dims_of(cfg) -> dict:
    """The port's model configuration under the published config.json's
    keys (the reference's `dims`)."""
    return dict(
        hidden_size=cfg.d_model, num_hidden_layers=cfg.n_layers,
        layer_types=["mamba" if s.kind == "ssd" else "attention"
                     for s in cfg.layer_specs()],
        mamba_n_heads=cfg.ssd_n_heads, mamba_d_head=cfg.ssd_headdim,
        mamba_d_state=cfg.ssd_state, mamba_n_groups=1,
        mamba_d_conv=cfg.conv_width, mamba_chunk_size=cfg.ssd_chunk,
        mamba_expand=cfg.ssd_expand, num_attention_heads=cfg.n_heads,
        num_key_value_heads=cfg.n_kv_heads,
        attention_multiplier=cfg.attn_scale or cfg.head_dim ** -0.5,
        num_local_experts=cfg.n_experts, num_experts_per_tok=cfg.top_k,
        intermediate_size=cfg.moe_d_ff,
        shared_intermediate_size=cfg.shared_width,
        embedding_multiplier=cfg.embed_multiplier,
        residual_multiplier=cfg.residual_multiplier,
        logits_scaling=cfg.logits_scaling, rms_norm_eps=cfg.norm_eps,
        vocab_size=cfg.padded_vocab, tie_word_embeddings=cfg.tie_embeddings)


def model_config(config: dict):
    """The port's configuration the file names ("model": name, preset
    CONFIG or SMOKE); CONFIG is held to the file's published keys."""
    from repro_torch import configs

    m = config["model"]
    cfg = configs.get_config(m["name"], smoke=m["preset"] == "SMOKE")
    if m["preset"] == "CONFIG":
        dims = dims_of(cfg)
        off = [k for k in PUBLISHED if dims[k] != config[k]]
        if off or cfg.use_rope != (config["position_embedding_type"] != "nope"):
            raise ValueError(f"{cfg.name}: the port's configuration differs "
                             f"from the published one at {off or 'rope'}")
    return cfg


def prompt_of(config: dict, vocab: int, spec: dict) -> np.ndarray:
    """A search's prompt: `prompt_tokens` lengths spread over each block
    of `prompt_block` uids, tokens drawn from the search's seed."""
    lo, hi = config["lm"]["prompt_tokens"]
    block = config["lm"]["prompt_block"]
    n = int(spread(lo, hi, block)[spec["uid"] % block])
    return np.random.default_rng([int(spec["seed"]), 0x70]).integers(
        0, vocab, n)


def make_params(cfg, dims: dict, seed: int, device) -> dict:
    """The port's parameter tree (models.lm's layout: stacks [repeats,
    ...] a pattern position, the matrices in the model's dtype, the rest
    float32), filled layer by layer from the reference's draw: each layer
    drawn once, straight into its stacks."""
    import torch

    from repro_torch.models import layers as L

    wide = {("mix", k) for k in ("in_proj", "out_proj", "wq", "wk", "wv",
                                 "wo")} | {("moe", k) for k in ("wi", "wg",
                                                                "wo")} | \
        {("moe", "shared", k) for k in ("wi", "wg", "wo")}
    d, H, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    params = {"embed": {"tok": ref.draw_embed(dims, seed, device)},
              "final_norm": {"scale": torch.ones(d, device=device)}}
    base = 0
    for gi, (pattern, repeats) in enumerate(cfg.groups):
        stacks = [{} for _ in pattern]
        for r in range(repeats):
            for i, spec in enumerate(pattern):
                w = ref.draw_layer(dims, seed, base + r * len(pattern) + i,
                                   device)
                put = {("norm_in", "scale"): w["input_norm"],
                       ("norm_mlp", "scale"): w["post_norm"],
                       ("moe", "router"): w["router"],
                       ("moe", "wi"): w["w_in"], ("moe", "wg"): w["w_gate"],
                       ("moe", "wo"): w["w_out"],
                       ("moe", "shared", "wi"): w["shared_in"],
                       ("moe", "shared", "wg"): w["shared_gate"],
                       ("moe", "shared", "wo"): w["shared_out"]}
                if spec.kind == "ssd":
                    put.update({("mix", "conv", "w"): w["conv_w"],
                                ("mix", "conv", "b"): w["conv_b"]})
                    for k in ("in_proj", "A_log", "dt_bias", "D", "norm",
                              "out_proj"):
                        put[("mix", k)] = w[k]
                else:
                    put.update({("mix", "wq"): w["q"].view(d, H, dh),
                                ("mix", "wk"): w["k"].view(d, Hkv, dh),
                                ("mix", "wv"): w["v"].view(d, Hkv, dh),
                                ("mix", "wo"): w["o"].view(H, dh, d)})
                for path, src in put.items():
                    node = stacks[i]
                    for k in path[:-1]:
                        node = node.setdefault(k, {})
                    if r == 0:
                        node[path[-1]] = torch.empty(
                            (repeats, *src.shape), device=device,
                            dtype=L.dt(cfg) if path in wide
                            else torch.float32)
                    node[path[-1]][r].copy_(src)
                del w, put
        params[f"g{gi}"] = stacks
        base += repeats * len(pattern)
    return params


def _recording_classes():
    from repro_torch.sim.lm import LMContinuationBackend, LMTreeEnv

    class RecordingEnv(LMTreeEnv):
        """LMTreeEnv keeping each expanded state's top tokens, and its
        logits at them and at the probe ids."""

        def __init__(self, *a, probes, **k):
            super().__init__(*a, **k)
            self.probes = probes
            self.tops: dict = {}
            self.rows: dict = {}
            self.conflicts = 0

        def logits(self, state):
            out = super().logits(state)
            key = np.asarray(state, np.float32).tobytes()
            if key not in self.rows:
                ids = np.concatenate([np.argsort(-out)[: self.F],
                                      self.probes])
                self.rows[key] = (ids, out[ids].copy())
            return out

        def top_actions(self, state):
            top = super().top_actions(state)
            key = np.asarray(state, np.float32).tobytes()
            have = self.tops.setdefault(key, np.array(top))
            self.conflicts += not np.array_equal(have, top)
            return top

    class RecordingBackend(LMContinuationBackend):
        """LMContinuationBackend keeping each simulated state's value and
        the continuation it decoded."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.conts: dict = {}

        def evaluate(self, states):
            values, _ = super().evaluate(states)
            decoded = {np.asarray(r.prompt, np.int64).tobytes(): r.tokens
                       for r in self.batcher.completed}
            for s, v in zip(states, values):
                key = np.asarray(s, np.float32).tobytes()
                if key not in self.conts:
                    toks = self.env.tokens(s).tobytes()
                    self.conts[key] = (float(v), list(decoded[toks]))
            return values, None

    return RecordingEnv, RecordingBackend


class RecordingSim:
    """The simulation as the trees see it (above the server's padding):
    each real row's state and value, in order."""

    def __init__(self, inner):
        self.inner = inner
        self.values: dict = {}     # state bytes -> [value, ...] in order

    def bind_metrics(self, metrics) -> None:
        self.inner.bind_metrics(metrics)

    def bind_tracer(self, tracer) -> None:
        self.inner.bind_tracer(tracer)

    def evaluate(self, states):
        values, priors = self.inner.evaluate(states)
        for s, v in zip(states, values):
            self.values.setdefault(np.asarray(s, np.float32).tobytes(),
                                   []).append(np.float32(v))
        return values, priors


class ReplayEnv:
    """The reference's token environment: a state steps by the program's
    top tokens for it; it ends `horizon` short of max_len."""

    def __init__(self, tops: dict, F: int, max_len: int, horizon: int):
        self.tops, self.F = tops, F
        self.max_len, self.horizon = max_len, horizon
        self.missing = False

    def num_actions(self, s) -> int:
        return 0 if int(s[0]) >= self.max_len - self.horizon else self.F

    def step(self, s, a: int):
        top = self.tops.get(np.asarray(s, np.float32).tobytes())
        s2 = np.array(s, np.float32)
        n = int(s[0])
        if top is None:            # never expanded by the program
            self.missing = True
            tok = -1
        else:
            tok = int(top[a])
        s2[1 + n], s2[0] = tok, n + 1
        return s2, 0.0, n + 1 >= self.max_len - self.horizon


class System:
    net_sample_rows = 6        # states the net stage checks

    def __init__(self, config: dict, seed: int, device, trace: bool):
        import torch

        from repro_torch.sim import SimServer
        from repro_torch.sim.lm import capacity

        cfg = model_config(config)
        self.config, self.seed, self.device = config, int(seed), device
        self.dims = dims_of(cfg)
        lmc, tree = config["lm"], config["tree"]
        if torch.device(device).type == "cuda":
            from repro_torch.kernels import build

            build.build_all(("flash_attention",))
        params = make_params(cfg, self.dims, seed, device)
        self.max_len = capacity(lmc["prompt_tokens"][1], lmc["max_moves"],
                                tree["D"], lmc["horizon"])
        self.probes = np.random.default_rng([self.seed, 0x9B]).choice(
            self.dims["vocab_size"], PROBES, replace=False)
        Env, Backend = _recording_classes()
        self.env = Env(cfg, params, fanout=tree["F"], horizon=lmc["horizon"],
                       impl=lmc["impl"], max_len=self.max_len, snapshots=True,
                       cuda_graphs=tree["D"], probes=self.probes)
        del params
        self.backend = Backend(self.env, pool_size=lmc["pool_size"])
        self.sim = RecordingSim(SimServer(self.backend,
                                          max_batch=config["sim"]["max_batch"]))
        self.client = make_client(config, self.env, self.sim, device, trace)
        self.read: set = set()         # the states the replays read
        self._checked = None

    def request(self, spec: dict):
        from repro_torch.service import SearchRequest

        self.env.register(spec["seed"], prompt_of(
            self.config, self.dims["vocab_size"], spec))
        return SearchRequest(uid=spec["uid"], seed=spec["seed"],
                             budget=spec["budget"], moves=spec["moves"])

    def close(self) -> None:
        """Close the client and let the model go: what the check reads is
        kept (the answers, the drop count), the weights and caches are
        freed."""
        env, backend = self.env, self.backend
        self.dropped = env.counters.dropped + backend.batcher.counters.dropped
        self.tops, self.rows = env.tops, env.rows
        self.conflicts = env.conflicts
        self.conts, self.values = backend.conts, self.sim.values
        self.client.close()
        self.client = self.env = self.backend = None
        self.sim.inner = None

    # ---- reference ----
    def root_state(self, spec: dict) -> np.ndarray:
        prompt = prompt_of(self.config, self.dims["vocab_size"], spec)
        s = np.zeros(self.max_len + 1, np.float32)
        s[0], s[1:1 + len(prompt)] = len(prompt), prompt
        return s

    def reference_moves(self, spec: dict, n: int) -> list:
        tree, server = self.config["tree"], self.config["server"]
        env = ReplayEnv(self.tops, tree["F"], self.max_len,
                        self.config["lm"]["horizon"])
        taken: dict = {}

        def answers(states):
            out = np.zeros(len(states), np.float32)
            for i, s in enumerate(states):
                key = np.asarray(s, np.float32).tobytes()
                seen = self.values.get(key, [])
                k = taken.get(key, 0)
                if k >= len(seen):
                    env.missing = True
                    continue
                out[i] = seen[k]
                taken[key] = k + 1
                self.read.add(key)
            return out, None

        moves = ref_search.run_search(
            ref_tree.Shape(**tree), env, answers, self.root_state(spec),
            server["p"], spec["budget"], spec["moves"], n,
            reuse_subtree=server["reuse_subtree"],
            alternating_signs=server["alternating_signs"])
        # a state the program never answered: the replay left its path
        return [] if env.missing else moves

    def checked_rows(self) -> list:
        """(state bytes, continuation) of the states the net stage
        checks: simulated and expanded ones first, those the replays read
        before the rest; half the sample the last such states the program
        answered (after the most commits, so through advanced
        snapshots), the rest drawn from the seed."""
        rng = np.random.default_rng([self.seed, 0xC4])
        both = [k for k in self.conts if k in self.rows]
        pool = [k for k in both if k in self.read] or both or list(self.conts)
        late = max(0, len(pool) - (self.net_sample_rows + 1) // 2)
        take = list(range(late, len(pool)))
        take += sorted(rng.permutation(late)[: self.net_sample_rows
                                             - len(take)])
        return [(pool[i], self.conts[pool[i]][1]) for i in sorted(take)]

    def reference_rows(self, low: bool = False, fp8: bool = False) -> list:
        """The reference's (logits, value) of each checked row (`low`,
        `fp8`: reference/granite_hybrid.py's lower precisions)."""
        rows = self.checked_rows()
        items = [(np.frombuffer(k, np.float32), c) for k, c in rows]
        items = [(s[1:1 + int(s[0])].astype(np.int64),
                  np.asarray(c, np.int64)) for s, c in items]
        return rows, ref.continuation_check(self.dims, self.seed, items,
                                            self.device, low, fp8)

    def gaps(self, rows: list, answers: list) -> dict:
        """The largest gaps of the program's logits (at a row's top
        tokens and the probes) and values to `answers`; `logit_rms_gap`,
        the largest row's root-mean-square logit gap, is reported."""
        logit_gap = value_gap = rms = 0.0
        for (key, _), (logits, value) in zip(rows, answers):
            if key in self.rows:
                ids, got = self.rows[key]
                d = np.abs(got - logits[ids])
                logit_gap = max(logit_gap, float(d.max()))
                rms = max(rms, float(np.sqrt((d ** 2).mean())))
            value_gap = max(value_gap, abs(self.conts[key][0] - value))
        return {"logit_gap": logit_gap, "value_gap": value_gap,
                "logit_rms_gap": rms}

    def extra_checks(self) -> dict:
        rows, answers = self.reference_rows()
        self._checked = (rows, answers)
        self.gaps_seen = self.gaps(rows, answers)
        return {"moe_tokens_dropped": self.dropped,
                "conflicting_rows": self.conflicts,
                **self.gaps_seen, "net_rows_checked": len(rows)}


def control(name: str, seed: int, seconds: float, overrides: dict = None,
            device: str = "cuda", part: str = "all") -> dict:
    """One run of the cell (a plain run: its own readings are printed
    too), then the checked rows again by the reference one precision
    down (`part` "all", or "state_router": the SSD state and the router
    alone): its gaps to the float32 reference."""
    from mcts_bench import cell, check

    ctx = cell.measure(name, seed, seconds, False, device=device,
                       overrides=overrides)
    checks = check.compare(ctx.system, ctx.loop, ctx.config,
                           ctx.cell["check_searches"], seed)
    system = ctx.system
    rows, want = system._checked
    _, low = system.reference_rows(low=True, fp8=part == "all")
    # the control in the program's place: its answers against the
    # float32 reference's, at the ids the program's record holds
    system.rows = {k: (ids, low[i][0][ids]) for i, (k, _) in enumerate(rows)
                   for ids in [system.rows[k][0]] if k in system.rows}
    system.conts = {k: (low[i][1], system.conts[k][1])
                    for i, (k, _) in enumerate(rows)}
    gaps = system.gaps(rows, want)
    return {"program": {k: c["value"] for k, c in checks.items()},
            "program_logit_rms_gap": system.gaps_seen["logit_rms_gap"],
            "control": part, **{"control_" + k: v for k, v in gaps.items()},
            "rows": len(rows)}


def main() -> None:
    import argparse
    import json
    import time

    ap = argparse.ArgumentParser(description="the granite control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--part", choices=("all", "state_router"), default="all")
    args = ap.parse_args()
    from mcts_bench import manifest

    seconds = args.seconds or manifest.benchmark()["run_seconds"]
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = control(args.workload, seed, seconds, part=args.part)
        out.update(workload=args.workload, seed=seed,
                   seconds=time.perf_counter() - t0)
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
