"""Run the JAX package's own test bodies against repro_torch.

``port_module("test_client")`` loads tests/test_client.py with its
imports pointed at the port: the source is parsed, rewritten on the AST
and executed as a new module, so every test body runs unchanged against
repro_torch (no copy of it exists).  The rewrite:

  * ``repro`` / ``repro.x`` imports become ``repro_torch`` / ``repro_torch.x``;
  * the port's names stand where the JAX package's do (TorchArenaExecutor
    for JaxArenaExecutor, CudaArenaExecutor for PallasArenaExecutor, the
    executor name "cuda" for "pallas");
  * every call of a serving entry point (and of ``init_caches``) gets
    ``device="cpu"``, since the port's entry points run on CUDA unless the
    caller asks for the CPU;
  * the weights a body builds from a JAX key come from the JAX package,
    carried into the port's layout (``REBIND``): the policy net's
    ``init_params`` is ``jax_key_init_params`` (through the port's
    ``params_from_numpy``) and the LM's ``lm.init_params`` is
    ``jax_key_lm.init_params`` (through ``from_jax_params``), so the
    port's NN and LM legs compute the JAX package's functions (the rest
    of ``lm`` is the port's);
  * in a module listed in ``SHIMS``, ``jax`` and ``jnp`` are rebound after
    the module runs.  In the device-twin tests of
    tests/test_fused_dispatch.py ``jax.jit(f)`` calls f on torch tensors
    made from its numpy arguments, and ``jnp.asarray`` / ``jnp.zeros``
    make CPU tensors, so a body that jits a device twin runs the port's
    twin.  In tests/test_models_smoke.py ``jax.random.randint`` draws
    JAX's numbers into a torch tensor and the few ``jnp`` calls the bodies
    make on tokens, frames, patches and logits are torch's, so a body's
    prefill, decode and train step run the port's steps on the JAX
    package's weights and tokens (``jax.tree`` stays JAX's, which walks
    dicts and lists of torch tensors as it walks arrays).  In
    tests/test_serving.py ``jnp`` is torch's for the same few calls, so its
    ``greedy_reference`` decodes with the port; tests/test_batcher.py's
    ``greedy_reference`` (imported from test_serving, a test module the
    rewrite leaves alone) is that ported one, so neither hands the port's
    torch weights to the JAX package nor a jax array to the port.  In
    tests/test_optim_sharding_data.py and tests/test_checkpoint.py the
    bodies' ``jnp`` calls make torch tensors (float64 input as float32,
    as JAX makes it) and ``jax.random.normal`` draws JAX's numbers into
    one, so the optimizers, compression and checkpoints run on the port's
    trees; ``train_main`` (the launcher) gets ``device="cpu"``, and
    ``jax.make_mesh`` gives the mesh's shape (launch.mesh.MeshShape), which
    is all the sharding rules read.

``cases(module, exclude)`` expands each remaining test function's
``pytest.mark.parametrize`` marks into (id, function, kwargs) cases for
one parametrised test of the caller.  Test data, not a test module.
"""

from __future__ import annotations

import ast
import inspect
import itertools
import types
from pathlib import Path

import numpy as np
import torch

TESTS = Path(__file__).resolve().parent

NAME_MAP = {"JaxArenaExecutor": "TorchArenaExecutor",
            "PallasArenaExecutor": "CudaArenaExecutor",
            # the JAX fused program (a jitted function; only its lowering
            # tests use it, and those do not apply to the port)
            "_fused_program": "FusedProgram"}
VALUE_MAP = {"pallas": "cuda"}
DEVICE_CALLS = {"SearchClient", "SearchService", "ServiceFrontend",
                "ArenaPool", "TreeParallelMCTS", "make_arena_executor",
                "make_intree_executor", "TorchArenaExecutor",
                "CudaArenaExecutor", "NNSimBackend", "init_caches",
                "train_main"} | set(NAME_MAP)
# (JAX module, name) -> the name in this module that stands for it
REBIND = {("repro.envs.policy_net", "init_params"): "jax_key_init_params",
          ("repro.models", "lm"): "jax_key_lm"}


def _to_port(name: str) -> str:
    if name == "repro" or name.startswith("repro."):
        return "repro_torch" + name[len("repro"):]
    return name


class _ToPort(ast.NodeTransformer):
    def visit_Import(self, node):
        for a in node.names:
            if a.asname is None and _to_port(a.name) != a.name:
                # `import repro.x` binds `repro`; keep the body's spelling
                raise NotImplementedError(f"bare import of {a.name}")
            a.name = _to_port(a.name)
        return node

    def visit_ImportFrom(self, node):
        if node.level != 0:
            return node
        rebound = [ast.ImportFrom("port_cases", [ast.alias(
            REBIND[(node.module, a.name)], a.asname or a.name)], 0)
            for a in node.names if (node.module, a.name) in REBIND]
        node.names = [a for a in node.names
                      if (node.module, a.name) not in REBIND]
        if node.module:
            node.module = _to_port(node.module)
        for a in node.names:
            if a.name in NAME_MAP:
                a.asname = a.asname or a.name
                a.name = NAME_MAP[a.name]
        return ([node] if node.names else []) + rebound

    def visit_Attribute(self, node):
        self.generic_visit(node)
        node.attr = NAME_MAP.get(node.attr, node.attr)
        return node

    def visit_Constant(self, node):
        if isinstance(node.value, str) and node.value in VALUE_MAP:
            node.value = VALUE_MAP[node.value]
        return node

    def visit_Call(self, node):
        self.generic_visit(node)
        f = node.func
        name = f.id if isinstance(f, ast.Name) else getattr(f, "attr", None)
        if name in DEVICE_CALLS and not any(k.arg == "device"
                                            for k in node.keywords):
            node.keywords.append(
                ast.keyword(arg="device", value=ast.Constant("cpu")))
        return node


def jax_key_init_params(key, channels: int = 32) -> dict:
    """The JAX package's policy-net init_params(key, channels), carried
    into the port's layout by params_from_numpy."""
    from repro.envs.policy_net import init_params
    from repro_torch.envs.policy_net import params_from_numpy

    return params_from_numpy({k: np.asarray(v) for k, v in
                              init_params(key, channels).items()})


def _jax_key_lm_init_params(cfg, key) -> dict:
    """The JAX package's lm.init_params(its config of cfg's name, key),
    carried into the port by from_jax_params, on the CPU."""
    import jax

    from repro import configs as jconfigs
    from repro.models import lm as jlm
    from repro_torch.models.lm import from_jax_params

    smoke = cfg.name.endswith("-smoke")
    jcfg = jconfigs.get_config(cfg.name.removesuffix("-smoke"), smoke=smoke)
    params = jlm.init_params(jcfg, key)
    return from_jax_params(cfg, jax.tree.map(np.asarray, params), "cpu")


class _JaxKeyLM:
    """repro_torch.models.lm with its init_params taking a JAX key."""

    init_params = staticmethod(_jax_key_lm_init_params)

    def __getattr__(self, name):
        from repro_torch.models import lm
        return getattr(lm, name)


jax_key_lm = _JaxKeyLM()


def _jit(fn):
    def run(*args, **kwargs):
        conv = lambda a: (torch.as_tensor(np.asarray(a))
                          if isinstance(a, (np.ndarray, np.generic)) else a)
        return fn(*map(conv, args), **{k: conv(v) for k, v in kwargs.items()})
    return run


JAX_SHIM = types.SimpleNamespace(jit=_jit)
JNP_SHIM = types.SimpleNamespace(
    asarray=lambda x: torch.as_tensor(np.asarray(x)),
    zeros=lambda shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype),
    int32=torch.int32)


def _jax_key(seed):
    import jax
    return jax.random.PRNGKey(seed)


def _jax_randint(key, shape, lo, hi):
    import jax
    return torch.as_tensor(np.array(jax.random.randint(key, shape, lo, hi)))


def _jax_normal(key, shape):
    import jax
    return torch.as_tensor(np.array(jax.random.normal(key, shape)))


class _JaxTree:
    """jax.tree, imported when first used."""

    def __getattr__(self, name):
        import jax
        return getattr(jax.tree, name)


def _tensor(x, dtype=None):
    """jnp.asarray on torch: float64 input becomes float32, as in JAX."""
    a = np.asarray(x)
    if dtype is None and a.dtype == np.float64:
        dtype = torch.float32
    return torch.as_tensor(a, dtype=dtype)


JAX_MODELS_SHIM = types.SimpleNamespace(
    jit=_jit, random=types.SimpleNamespace(PRNGKey=_jax_key,
                                           randint=_jax_randint),
    tree=_JaxTree())
JNP_MODELS_SHIM = types.SimpleNamespace(
    asarray=lambda x: torch.as_tensor(np.asarray(x)), argmax=torch.argmax,
    roll=torch.roll, stack=torch.stack, float32=torch.float32,
    ones=lambda shape, dtype=torch.float32: torch.ones(shape, dtype=dtype),
    full=lambda shape, value, dtype=torch.float32: torch.full(
        shape, value, dtype=dtype))
JNP_SERVING_SHIM = types.SimpleNamespace(
    asarray=lambda x, dtype=None: torch.as_tensor(np.asarray(x), dtype=dtype),
    argmax=torch.argmax, int32=torch.int32)


def _ported_greedy_reference(cfg, params, prompt, n_new):
    """tests/test_serving.py's greedy_reference, run on the port."""
    return port_module("test_serving").greedy_reference(cfg, params, prompt,
                                                        n_new)


def _mesh_shape(shape, axes):
    """jax.make_mesh on the port: the mesh's names and sizes (a
    launch.mesh.MeshShape), all the sharding rules read."""
    from repro_torch.launch.mesh import MeshShape
    return MeshShape(tuple(axes), tuple(shape))


JAX_TRAIN_SHIM = types.SimpleNamespace(
    tree=_JaxTree(), random=types.SimpleNamespace(PRNGKey=_jax_key,
                                                  normal=_jax_normal),
    make_mesh=_mesh_shape)
JNP_TRAIN_SHIM = types.SimpleNamespace(
    asarray=_tensor, arange=lambda n, dtype=None: torch.arange(n, dtype=dtype),
    ones=lambda shape, dtype=torch.float32: torch.ones(shape, dtype=dtype),
    abs=torch.abs, sqrt=torch.sqrt, sum=torch.sum, linalg=torch.linalg,
    int8=torch.int8, int32=torch.int32, float32=torch.float32)

SHIMS = {"test_fused_dispatch": {"jax": JAX_SHIM, "jnp": JNP_SHIM},
         "test_models_smoke": {"jax": JAX_MODELS_SHIM, "jnp": JNP_MODELS_SHIM},
         "test_serving": {"jnp": JNP_SERVING_SHIM},
         "test_batcher": {"greedy_reference": _ported_greedy_reference},
         "test_optim_sharding_data": {"jax": JAX_TRAIN_SHIM,
                                      "jnp": JNP_TRAIN_SHIM},
         "test_checkpoint": {"jax": JAX_TRAIN_SHIM, "jnp": JNP_TRAIN_SHIM}}

_MODULES: dict = {}


def port_module(name: str) -> types.ModuleType:
    """tests/<name>.py, executed with its imports pointed at the port."""
    if name not in _MODULES:
        path = TESTS / f"{name}.py"
        tree = ast.fix_missing_locations(
            _ToPort().visit(ast.parse(path.read_text(), str(path))))
        mod = types.ModuleType(f"{name}_on_port")
        mod.__file__ = str(path)
        exec(compile(tree, str(path), "exec"), mod.__dict__)
        mod.__dict__.update(SHIMS.get(name, {}))
        _MODULES[name] = mod
    return _MODULES[name]


def cases(name: str, exclude: dict) -> list:
    """Every test function of tests/<name>.py on the port but those in
    `exclude` ({test name: why}), with its parametrize marks expanded:
    a list of (id, function, kwargs)."""
    mod = port_module(name)
    out = []
    for fname, fn in vars(mod).items():
        if not fname.startswith("test_") or not inspect.isfunction(fn):
            continue
        if fname in exclude:
            continue
        axes = []
        for mark in getattr(fn, "pytestmark", []):
            if mark.name != "parametrize":
                continue
            argnames, values = mark.args[0], mark.args[1]
            ids = mark.kwargs.get("ids")
            names = [a.strip() for a in argnames.split(",")] \
                if isinstance(argnames, str) else list(argnames)
            rows = []
            for i, v in enumerate(values):
                vals = v if len(names) > 1 else (v,)
                tag = (ids[i] if isinstance(ids, (list, tuple))
                       else ids(v) if callable(ids) else str(v))
                rows.append((tag, dict(zip(names, vals))))
            axes.append(rows)
        for combo in itertools.product(*axes):
            kw = {}
            for _, d in combo:
                kw.update(d)
            tag = "-".join(t for t, _ in combo)
            out.append((f"{name}::{fname}" + (f"[{tag}]" if tag else ""),
                        fn, kw))
    return out


def run_case(fn, kwargs: dict, request) -> None:
    """Call one case, handing it the pytest fixtures its signature names
    (tmp_path, monkeypatch, ...) through `request`."""
    kw = dict(kwargs)
    for p in inspect.signature(fn).parameters:
        if p not in kw:
            kw[p] = request.getfixturevalue(p)
    fn(**kw)
