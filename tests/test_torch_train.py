"""The port's training path (repro_torch.optim, data, distributed,
launch.specs, launch.train and the train half of models.steps) against
the JAX package's on the CPU.

Inputs are numpy arrays from seeds handed to both packages; LM weights
are the JAX package's init_params carried across with from_jax_params.
Bounds: the schedule, compression, the data stream and checkpoints are
equal bit for bit; optimizer updates and state at f32 within 1e-6 of
each leaf's largest entry, at bf16 equal but for at most BF16_ULP_ENTRIES
entries one bf16 ulp apart (of 71,967; Adafactor's rsqrt and means
differ in the last f32 bit now and then); loss_fn's loss and metrics
within 1e-5 and its gradients within 1e-4 of each leaf's largest entry
(f32, every SMOKE arch, blockwise attention); three train steps' losses
within 1e-4.  Also the JAX package's own test_optim_sharding_data.py and
test_checkpoint.py bodies on the port (port_cases), the launcher's
restart-replay among them.
"""

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import port_cases
from repro import configs as jconfigs
from repro.data import SyntheticTokens as JTokens
from repro.launch import specs as jspecs
from repro.models import lm as jlm
from repro.models import steps as jsteps
from repro.optim import compression as jcomp
from repro.optim import optimizers as jopt
from repro_torch import configs as tconfigs
from repro_torch.data import Prefetcher, SyntheticTokens
from repro_torch.distributed import CheckpointManager, checkpoint as tckpt
from repro_torch.distributed import restore_checkpoint, save_checkpoint
from repro_torch.launch import specs
from repro_torch.models import attention as TA
from repro_torch.models import lm as tlm
from repro_torch.models import steps as tsteps
from repro_torch.optim import compression as tcomp
from repro_torch.optim import optimizers as topt
from repro_torch.pytree import tree_leaves

F32_TOL = 1e-6          # optimizer updates and state at f32, of the leaf's max
LOSS_TOL = 1e-5         # loss_fn's loss and metrics
GRAD_TOL = 1e-4         # gradients, of each leaf's largest entry
STEP_TOL = 1e-4         # three train steps' losses
BF16_ULP_ENTRIES = 4    # bf16 update entries one ulp apart (measured: 0-2)

STEPS = (0, 1, 5, 150)
SHAPES = {"a": (130, 140), "b": {"c": (7,)}, "d": [(2, 128, 160), (64, 200)]}


def to_np(t):
    """A torch tensor as numpy (bf16 as ml_dtypes.bfloat16)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def to_torch(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def jax_tree(tree):
    return jax.tree.map(lambda a: jnp.asarray(a), tree)


def torch_tree(tree):
    return jax.tree.map(lambda a: to_torch(np.asarray(a)), tree)


def drawn(seed, dtype, scale=1.0):
    """A tree of SHAPES drawn from `seed` as numpy arrays of `dtype`."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda s: (rng.randn(*s) * scale).astype(dtype),
                        SHAPES, is_leaf=lambda x: isinstance(x, tuple))


def paired_leaves(j, t):
    """[(path, jax leaf as f32 numpy, port leaf as f32 numpy)]."""
    jl = jax.tree_util.tree_leaves_with_path(j)
    tl = tree_leaves(t)
    assert len(jl) == len(tl)
    return [(jax.tree_util.keystr(p), np.asarray(a).astype(np.float32),
             to_np(b).astype(np.float32)) for (p, a), b in zip(jl, tl)]


def within_max(j, t, tol, finite_only=False):
    """Each port leaf within tol of the JAX leaf's largest entry; with
    finite_only, only where the JAX leaf is finite (and the port's must
    be finite everywhere)."""
    for path, a, b in paired_leaves(j, t):
        if finite_only:
            assert np.isfinite(b).all(), path
            b = b[np.isfinite(a)]
            a = a[np.isfinite(a)]
        scale = max(float(np.abs(a).max(initial=0.0)), 1e-30)
        assert np.abs(a - b).max(initial=0.0) <= tol * scale, (
            path, np.abs(a - b).max(), scale)


def bf16_ulps_apart(j, t) -> int:
    """The entries that differ over the tree; every difference must be
    one bf16 ulp."""
    n = 0
    for (p, a), b in zip(jax.tree_util.tree_leaves_with_path(j),
                         tree_leaves(t)):
        ai = np.asarray(a).view(np.int16).astype(np.int32)
        bi = to_np(b).view(np.int16).astype(np.int32)
        diff = ai != bi
        assert np.abs(ai - bi)[diff].max(initial=0) <= 1, jax.tree_util.keystr(p)
        n += int(diff.sum())
    return n


# -------------------------------------------------------------- optimizers

def test_schedule_and_clip_match_jax():
    """cosine_schedule bit for bit over warmup, cosine and past total;
    clip_by_global_norm's norm within 2e-6 (the sums of squares are
    reduced in another order: over bf16 leaves XLA's sum is 1.4e-6 off
    the float64 norm, torch's 2e-8) and its clipped leaves within 2e-7
    of their largest entry (f32) or equal (bf16, unclipped)."""
    jl, tl = jopt.cosine_schedule(3e-4, 100, 10_000), \
        topt.cosine_schedule(3e-4, 100, 10_000)
    for s in (0, 1, 5, 50, 99, 100, 101, 150, 5_000, 9_999, 10_000, 12_000):
        assert np.float32(jl(s)) == np.float32(tl(s).item()), s
        assert np.float32(jl(s)) == np.float32(tl(torch.tensor(s)).item()), s
    for dtype, max_norm in ((np.float32, 1.0), (ml_dtypes.bfloat16, 1e3)):
        g = drawn(11, dtype)
        jc, jn = jopt.clip_by_global_norm(jax_tree(g), max_norm)
        tc, tn = topt.clip_by_global_norm(torch_tree(g), max_norm)
        assert abs(float(jn) - float(tn)) <= 2e-6 * float(jn)
        within_max(jc, tc, 2e-7 if dtype == np.float32 else 0.0)


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_update_matches_jax(name, dtype, step):
    """One update from a state the JAX package built (two earlier
    updates), at f32 and bf16 parameters: updates and state against the
    JAX package's, through make_optimizer (warmup 10, total 200)."""
    np_dtype = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    jinit, jupd = jopt.make_optimizer(name, lr=1e-2, warmup=10, total=200)
    tinit, tupd = topt.make_optimizer(name, lr=1e-2, warmup=10, total=200)
    params = drawn(0, np_dtype)
    jp = jax_tree(params)
    st = jinit(jp)
    for k in (1, 2):
        _, st = jupd(jax_tree(drawn(k, np_dtype, 0.1)), st, jp, k)
    tst = torch_tree(jax.tree.map(np.asarray, st))
    # the port's init builds the JAX package's state tree
    assert (jax.tree.structure(tinit(torch_tree(params)))
            == jax.tree.structure(tst))
    g = drawn(3, np_dtype, 0.1)
    ju, jst = jupd(jax_tree(g), st, jp, step)
    tu, tst2 = tupd(torch_tree(g), tst, torch_tree(params), step)
    within_max(jst, tst2, F32_TOL)
    if dtype == "float32":
        within_max(ju, tu, F32_TOL)
    else:
        assert bf16_ulps_apart(ju, tu) <= BF16_ULP_ENTRIES
    if name == "adafactor":
        assert set(tst2["stats"]["a"]) == {"vr", "vc"}
        assert set(tst2["stats"]["b"]["c"]) == {"v"}


def test_specs_optimizer_for():
    for arch in tconfigs.ARCH_IDS:
        cfg = tconfigs.get_config(arch)
        assert specs.optimizer_for(cfg)[0] == jspecs.optimizer_for(
            jconfigs.get_config(arch))[0]
    assert specs.FSDP_ARCHS == jspecs.FSDP_ARCHS
    assert specs.ADAFACTOR_ARCHS == jspecs.ADAFACTOR_ARCHS


# ------------------------------------------------------------- compression

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compression_matches_jax(dtype):
    """compress_int8's q and scale, int8_roundtrip and topk_sparsify
    (values and residual) identical to the JAX package's."""
    np_dtype = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    rng = np.random.RandomState(5)
    g = (rng.randn(257, 33) * 3).astype(np_dtype)
    g[0, :4] = 0.5 * np.float32(np.abs(g.astype(np.float32)).max()) / 127 * \
        np.array([1, 3, 5, -7], np.float32)      # halves: round to even
    jq, js = jcomp.compress_int8(jnp.asarray(g))
    tq, ts = tcomp.compress_int8(to_torch(g))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert np.float32(js) == np.float32(ts.item())
    jr = jcomp.int8_roundtrip({"g": jnp.asarray(g)})["g"]
    tr = tcomp.int8_roundtrip({"g": to_torch(g)})["g"]
    np.testing.assert_array_equal(to_np(tr), np.asarray(jr))
    for frac in (0.01, 0.1, 0.5):
        (js_, jres), (ts_, tres) = (jcomp.topk_sparsify(jnp.asarray(g), frac),
                                    tcomp.topk_sparsify(to_torch(g), frac))
        np.testing.assert_array_equal(to_np(ts_), np.asarray(js_))
        np.testing.assert_array_equal(to_np(tres), np.asarray(jres))


# -------------------------------------------------------------------- data

@pytest.mark.parametrize("vocab,batch,seq,seed", [
    (512, 4, 32, 5), (128_256, 2, 512, 0), (97, 3, 64, 12)])
def test_synthetic_tokens_bit_identical(vocab, batch, seq, seed):
    j, t = JTokens(vocab, batch, seq, seed=seed), SyntheticTokens(
        vocab, batch, seq, seed=seed)
    for step in (0, 1, 17, 10_000):
        a, b = j.batch_at(step), t.batch_at(step)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_prefetcher_order_and_stream():
    src = SyntheticTokens(64, 2, 8, seed=3)
    ref = JTokens(64, 2, 8, seed=3)
    pf = Prefetcher(src, start_step=4, depth=2)
    try:
        for want in range(4, 9):
            s, b = pf.next()
            assert s == want
            np.testing.assert_array_equal(b["tokens"],
                                          ref.batch_at(want)["tokens"])
    finally:
        pf.close()


# --------------------------------------------------------------- the loss

def smoke_batch(cfg, B=2, S=24, seed=3) -> dict:
    """Tokens, shifted labels and a ragged mask (and paligemma's patches,
    whisper's frames), numpy from a seed."""
    rng = np.random.RandomState(seed)
    tok = rng.randint(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:],
             "mask": (rng.rand(B, S) > 0.2).astype(np.float32)}
    if cfg.vlm_patches:
        batch["patches"] = (rng.randn(B, cfg.vlm_patches, cfg.d_model)
                            * 0.1).astype(np.float32)
    if cfg.encoder is not None:
        batch["frames"] = (rng.randn(B, cfg.encoder.n_frames, cfg.d_model)
                           * 0.1).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _smoke_models(arch):
    jcfg = jconfigs.get_config(arch, smoke=True)
    tcfg = tconfigs.get_config(arch, smoke=True)
    jp = jax.jit(lambda k: jlm.init_params(jcfg, k))(jax.random.PRNGKey(0))
    tp = tlm.from_jax_params(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def smoke_models(arch):
    """(JAX config, port config, JAX params, the same params on the port)
    at SMOKE size: trees of the module's one draw per arch, copied at
    their containers (a test may replace a leaf)."""
    jcfg, tcfg, jp, tp = _smoke_models(arch)
    copy = lambda t: jax.tree.map(lambda x: x, t)
    return jcfg, tcfg, copy(jp), copy(tp)


def loss_and_grads(jcfg, tcfg, jp, tp, batch):
    """(JAX's and the port's ((loss, metrics), grads)) of loss_fn with
    blockwise attention (the JAX package's default)."""
    jout = jax.jit(jax.value_and_grad(
        functools.partial(jsteps.loss_fn, jcfg), has_aux=True))(
            jp, jax_tree(batch))
    tout = tsteps._value_and_grad(
        tcfg, tp, {k: torch.as_tensor(v) for k, v in batch.items()},
        "blockwise")
    return jout, tout


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_loss_and_grads_match_jax(arch):
    """loss_fn and its gradients: the MoE aux term (mixtral, deepseek)
    and the MTP leg (deepseek) included; every parameter leaf gets a
    gradient.  mamba2's SSD layer gives the JAX package NaN gradients
    (exp before the causal mask overflows, ROADMAP.md queue C): there
    the port's must be finite and match wherever JAX's are, and the next
    test holds them all at decays that do not overflow."""
    jcfg, tcfg, jp, tp = smoke_models(arch)
    batch = smoke_batch(jcfg)
    ((jl, jm), jg), ((tl, tm), tg) = loss_and_grads(jcfg, tcfg, jp, tp, batch)
    assert set(tm) == set(jm)
    assert ("mtp_nll" in tm) == jcfg.mtp
    for k in jm:
        assert abs(float(tm[k]) - float(jm[k])) <= LOSS_TOL, k
    assert abs(float(tl) - float(jl)) <= LOSS_TOL
    within_max(jg, tg, GRAD_TOL, finite_only=jcfg.ssd_state > 0)


def test_ssd_grads_match_jax_without_overflow():
    """mamba2 with A = -exp(A_log) scaled to 1/100 (the within-chunk decay
    sums stay far from exp's overflow): JAX's gradients are finite, and
    the port's match them all within 1e-4."""
    jcfg, tcfg, jp, tp = smoke_models("mamba2-2.7b")
    small = np.log(np.exp(np.asarray(jp["g0"][0]["mix"]["A_log"])) / 100)
    jp["g0"][0]["mix"]["A_log"] = jnp.asarray(small.astype(np.float32))
    tp["g0"][0]["mix"]["A_log"] = torch.as_tensor(small.astype(np.float32))
    (_, jg), (_, tg) = loss_and_grads(jcfg, tcfg, jp, tp, smoke_batch(jcfg))
    assert all(np.isfinite(np.asarray(a)).all() for a in jax.tree.leaves(jg))
    within_max(jg, tg, GRAD_TOL)


def test_flash_under_autograd_raises():
    """impl="flash" has no backward: under autograd the self-attention
    (attn_forward) and attend_all (whisper's encoder and cross-attention)
    raise; under no_grad they run (here the plain version)."""
    cfg = tconfigs.get_config("llama3.2-1b", smoke=True)
    p = tlm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    layer = tlm._at(p["g0"][0], 0)["mix"]
    layer = {k: v.clone().requires_grad_(True) for k, v in layer.items()}
    spec = cfg.layer_specs()[0]
    x = torch.randn(2, 5, cfg.d_model)
    pos = torch.arange(5, dtype=torch.int32)
    with pytest.raises(ValueError, match="no backward"):
        TA.attn_forward(cfg, spec, layer, x, pos, impl="flash")
    q = torch.randn(2, 5, cfg.n_heads, cfg.head_dim, requires_grad=True)
    k = torch.randn(2, 7, cfg.n_kv_heads, cfg.head_dim)
    with pytest.raises(ValueError, match="no backward"):
        TA.attend_all(q, k, k, "flash")
    with torch.no_grad():
        out, _ = TA.attn_forward(cfg, spec, layer, x, pos, impl="flash")
        want, _ = TA.attn_forward(cfg, spec, layer, x, pos, impl="naive")
        torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)
        assert TA.attend_all(q, k, k, "flash").shape == q.shape
    # naive and blockwise train
    for impl in ("naive", "blockwise"):
        out, _ = TA.attn_forward(cfg, spec, layer, x, pos, impl=impl)
        out.sum().backward()


# --------------------------------------------------------- the train step

TRAIN_CASES = [("llama3.2-1b", "blockwise", 1, False),
               ("llama3.2-1b", "naive", 2, False),
               ("llama3.2-1b", "blockwise", 1, True),
               ("llama3.2-1b", "naive", 2, True),
               ("deepseek-v3-671b", "naive", 1, False)]


@pytest.mark.parametrize("arch,impl,microbatches,compress", TRAIN_CASES)
def test_train_steps_match_jax(arch, impl, microbatches, compress):
    """Three steps of make_train_step from one init and the same batches
    (AdamW, warmup 1; deepseek: Adafactor with its MTP leg): losses and
    grad norms within 1e-4, the caller's trees untouched, and without
    compression the parameters within 1e-3 of each leaf's largest entry."""
    jcfg, tcfg, jp, tp = smoke_models(arch)
    name = "adafactor" if jcfg.mtp else "adamw"
    jinit, jupd = jopt.make_optimizer(name, lr=1e-2, warmup=1, total=50)
    tinit, tupd = topt.make_optimizer(name, lr=1e-2, warmup=1, total=50)
    kw = dict(microbatches=microbatches, impl=impl)
    jstep = jax.jit(jsteps.make_train_step(
        jcfg, jupd, compress_fn=jcomp.int8_roundtrip if compress else None,
        **kw))
    tstep = tsteps.make_train_step(
        tcfg, tupd, compress_fn=tcomp.int8_roundtrip if compress else None,
        **kw)
    js, ts = jinit(jp), tinit(tp)
    before = [t.clone() for t in tree_leaves(tp)]
    src = SyntheticTokens(jcfg.vocab, 4, 16, seed=1)
    for step in range(3):
        batch = src.batch_at(step)
        jp, js, jm = jstep(jp, js, step, jax_tree(batch))
        tp2, ts, tm = tstep(tp, ts, step, {k: torch.as_tensor(v)
                                           for k, v in batch.items()})
        if step == 0:
            for a, b in zip(before, tree_leaves(tp)):
                assert torch.equal(a, b)
        tp = tp2
        for k in ("loss", "nll", "grad_norm") + (("mtp_nll",) if jcfg.mtp
                                                 else ()):
            assert abs(float(tm[k]) - float(jm[k])) <= STEP_TOL * max(
                1.0, abs(float(jm[k]))), (step, k)
    if not compress:   # int8 rounding may flip a quantum, which AdamW scales up
        within_max(jp, tp, 1e-3)


# ------------------------------------------------------------- checkpoint

def test_checkpoint_roundtrip_bf16(tmp_path):
    """bf16, f32 and int32 leaves in nested dicts and lists come back bit
    for bit with their dtypes; the manifest records bf16 by name and the
    leaves in the JAX package's order."""
    g = torch.Generator().manual_seed(0)
    state = {"w": torch.randn(8, 16, generator=g).to(torch.bfloat16),
             "opt": [{"m": torch.randn(3, generator=g)},
                     {"m": torch.randn(2, 2, generator=g)}],
             "n": torch.arange(5, dtype=torch.int32),
             "a": torch.tensor(7, dtype=torch.int32)}
    save_checkpoint(tmp_path, 4, state, extra={"why": "test"})
    target = jax.tree.map(torch.zeros_like, state)
    out, manifest = restore_checkpoint(tmp_path, 4, target)
    assert manifest["dtypes"] == ["int32", "int32", "float32", "float32",
                                  "bfloat16"]
    assert manifest["extra"] == {"why": "test"}
    for a, b in zip(tree_leaves(state), tree_leaves(out)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the JAX package reads the same leaves in the same order
    data = np.load(tmp_path / "step_4" / "leaves.npz")
    assert data["l4"].dtype == np.uint16
    np.testing.assert_array_equal(data["l0"], 7)


def test_async_save_snapshots_before_return(tmp_path, monkeypatch):
    """save() returns with the host copy taken: an in-place step while the
    writer thread is held does not reach the checkpoint."""
    import threading

    gate = threading.Event()
    real = tckpt.save_checkpoint

    def held(*a, **k):
        assert gate.wait(30)
        return real(*a, **k)

    monkeypatch.setattr(tckpt, "save_checkpoint", held)
    w = torch.ones(4, 4)
    mgr = CheckpointManager(tmp_path, async_save=True)
    mgr.save(1, {"w": w})
    w.add_(5.0)                  # the in-place optimizer step
    gate.set()
    mgr.wait()
    _, out, _ = mgr.restore_latest({"w": torch.zeros(4, 4)})
    assert torch.equal(out["w"], torch.ones(4, 4))


# ---------------- the JAX package's own test bodies on the port (port_cases)

UNPORTED = {
    "test_elastic_restore_new_sharding": "asserts jax's NamedSharding on the "
                                         "restored leaves; its twin "
                                         "test_torch_launch.py::"
                                         "test_restore_onto_mesh restores "
                                         "onto a 1x1 gloo DeviceMesh and "
                                         "checks for DTensors",
}
CASES = (port_cases.cases("test_optim_sharding_data", UNPORTED)
         + port_cases.cases("test_checkpoint", UNPORTED))


@pytest.mark.parametrize("fn,kwargs", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_jax_train_case_on_port(fn, kwargs, request):
    """One test of tests/test_optim_sharding_data.py or
    tests/test_checkpoint.py, its own body run against repro_torch
    (test_train_resume_bit_equal runs the port's launcher on the CPU)."""
    port_cases.run_case(fn, kwargs, request)
