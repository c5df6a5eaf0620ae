"""The port's Gomoku, LM-decode and training examples against the JAX
package's on the CPU (the quickstart and service demo are in
tests/test_torch_examples.py).

  * gomoku_selfplay at --games 1 --p 4 with the JAX net's weights carried
    across (policy_net.params_from_numpy): the printed lines identical
    (so the moves, the winner and the value loss to 4 places); and
    train_net on one game's states and targets against the JAX
    original's (jax.value_and_grad, 30 epochs of SGD): the last loss and
    every weight within GOMOKU_TOL.
  * lm_mcts_decode at --tokens 2 --p 4 with the JAX LM's weights carried
    across (lm.from_jax_params): the printed lines (the decoded sequence)
    identical.
  * train_lm's run() at a narrow llama-family config against a JAX loop
    built from the calls the original makes: losses within LOSS_TOL; a
    run stopped after step 2 and resumed equal to the uninterrupted run;
    CFG_100M's fields and parameter count equal to the original's."""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from examples_cases import (captured, jax_example,  # noqa: E402,F401
                            one_torch_thread, run_jax, untimed)

from repro import configs as jconfigs  # noqa: E402
from repro.data import SyntheticTokens as JSyntheticTokens  # noqa: E402
from repro.envs.policy_net import init_params as jnet_init  # noqa: E402
from repro.models import lm as jlm, steps as jsteps  # noqa: E402
from repro.models.config import (LayerSpec as JLayerSpec,  # noqa: E402
                                 ModelConfig as JModelConfig,
                                 param_count as jparam_count)
from repro.optim import make_optimizer as jmake_optimizer  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.envs import GomokuEnv  # noqa: E402
from repro_torch.envs.policy_net import params_from_numpy  # noqa: E402
from repro_torch.examples import (  # noqa: E402
    gomoku_selfplay, lm_mcts_decode, train_lm)
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.config import (LayerSpec, ModelConfig,  # noqa: E402
                                       param_count)

# 30 epochs of SGD at lr 1e-2 in f32: the two nets' forwards and
# gradients differ by an ulp or so (torch's CPU convolutions against
# XLA's); the weights and the loss were measured within 3e-8 of JAX's
GOMOKU_TOL = 1e-6
LOSS_TOL = 1e-5          # as tests/test_torch_train.py holds loss_fn
NARROW = dict(name="narrow-llama", d_model=64, n_heads=4, n_kv_heads=2,
              head_dim=16, d_ff=128, vocab=256, tie_embeddings=True,
              dtype="float32")


def jax_net():
    return jnet_init(jax.random.PRNGKey(0))


def test_gomoku_selfplay_matches_jax():
    argv = ["--games", "1", "--p", "4"]
    want = untimed(run_jax("gomoku_selfplay", argv))
    params = params_from_numpy(jax.tree.map(np.asarray, jax_net()))
    args = gomoku_selfplay.parse_args(argv + ["--device", "cpu"])
    got = untimed(captured(gomoku_selfplay.run, args, params))
    assert want[0].startswith("game 0: ") and len(want) == 2
    assert got == want


def test_gomoku_train_net_matches_jax():
    jex = jax_example("gomoku_selfplay")
    jp = jax_net()
    params = params_from_numpy(jax.tree.map(np.asarray, jp))
    states, z, _ = gomoku_selfplay.play_games(
        GomokuEnv(), params, n_games=2, p=4, device="cpu")
    assert len(states) > 8 and set(z) <= {-1.0, 0.0, 1.0}
    jnew, jloss = jex.train_net(jp, states, z)
    new, loss = gomoku_selfplay.train_net(params, states, z, device="cpu")
    assert abs(loss - jloss) <= GOMOKU_TOL
    want = params_from_numpy(jax.tree.map(np.asarray, jnew))
    moved = 0
    for k, w in want.items():
        assert np.abs(new[k].numpy() - w.numpy()).max() <= GOMOKU_TOL, k
        moved += not torch.equal(w, params[k])
    assert moved == 4            # the value head and trunk; not the policy's


def test_lm_mcts_decode_matches_jax():
    argv = ["--tokens", "2", "--p", "4"]
    want = untimed(run_jax("lm_mcts_decode", argv))
    args = lm_mcts_decode.parse_args(argv + ["--device", "cpu"])
    cfg = configs.get_config(args.arch, smoke=True)
    jp = jlm.init_params(jconfigs.get_config(args.arch, smoke=True),
                         jax.random.PRNGKey(0))
    params = lm.from_jax_params(cfg, jax.tree.map(np.asarray, jp), "cpu")
    got = untimed(captured(lm_mcts_decode.decode, cfg, params, args.tokens,
                           args.p, args.pool_size, "cpu"))
    assert want[-1].startswith("decoded: [") and len(want) == 3
    assert got == want


def narrow_cfgs():
    return (JModelConfig(groups=(((JLayerSpec(),), 2),), **NARROW),
            ModelConfig(groups=(((LayerSpec(),), 2),), **NARROW))


def jax_losses(jcfg, params, steps, batch, seq) -> list:
    """The original's loop (make_optimizer, make_train_step blockwise,
    SyntheticTokens) without its checkpoint: each step's loss."""
    init, update = jmake_optimizer("adamw", lr=3e-4, warmup=20, total=steps)
    opt = init(params)
    train = jax.jit(jsteps.make_train_step(jcfg, update, impl="blockwise"))
    src = JSyntheticTokens(jcfg.vocab, batch, seq, seed=0)
    out = []
    for i in range(steps):
        b = {k: jnp.asarray(v) for k, v in src.batch_at(i).items()}
        params, opt, m = train(params, opt, jnp.asarray(i), b)
        out.append(float(m["loss"]))
    return out


def test_train_lm_run_matches_jax_and_resumes(tmp_path):
    jcfg, cfg = narrow_cfgs()
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))

    def carried():
        return lm.from_jax_params(cfg, jax.tree.map(np.asarray, jp), "cpu")

    want = jax_losses(jcfg, jp, 4, 2, 32)
    got = train_lm.run(cfg, 4, 2, 32, str(tmp_path / "a"), "cpu",
                       params=carried())
    assert sorted(got) == [0, 1, 2, 3]
    diff = np.abs(np.array([got[i] for i in range(4)]) - want)
    assert diff.max() <= LOSS_TOL
    first = train_lm.run(cfg, 2, 2, 32, str(tmp_path / "b"), "cpu",
                         params=carried())
    out = {}
    text = captured(lambda: out.setdefault("r", train_lm.run(
        cfg, 4, 2, 32, str(tmp_path / "b"), "cpu", params=carried())))
    assert "[100m] resumed at 2" in text.splitlines()
    # the schedule's warmup covers every step, so the stop changes nothing
    assert first == {i: got[i] for i in (0, 1)}
    assert out["r"] == {i: got[i] for i in (2, 3)}


def test_cfg_100m_matches_jax():
    """Every field of the JAX package's config has the port's value, and
    each field the port adds (granite-4.0-h's multipliers, NoPE, the
    shared-expert width, dropless routing, the published Mamba-2 block)
    holds its default, the JAX package's behaviour."""
    jcfg = jax_example("train_lm").CFG_100M
    port, jax_fields = dataclasses.asdict(train_lm.CFG_100M), \
        dataclasses.asdict(jcfg)
    assert {k: port[k] for k in jax_fields} == jax_fields
    added = {f.name: f.default for f in dataclasses.fields(train_lm.CFG_100M)
             if f.name not in jax_fields}
    assert {k: port[k] for k in added} == added
    assert param_count(train_lm.CFG_100M) == jparam_count(jcfg)
    assert 90e6 < param_count(train_lm.CFG_100M) < 110e6
