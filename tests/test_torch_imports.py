"""The port stands alone: src/repro_torch/ and chip_smoke.py import
neither jax nor anything of the JAX package (repro)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def imported_modules(path: Path) -> list:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.append(str(node.args[0].value))
    return names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax(path):
    bad = [n for n in imported_modules(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_loads_no_jax_module():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.kernels.ops\n"
        "import repro_torch.kernels.ref, repro_torch.kernels.build\n"
        "import repro_torch.envs, repro_torch.core.reroot\n"
        "import repro_torch.models.lm, repro_torch.models.steps\n"
        "import repro_torch.serving, repro_torch.sim, repro_torch.obs\n"
        "import repro_torch.launch.serve, repro_torch.configs.llama3_2_1b\n"
        "import repro_torch.core.sharded, repro_torch.launch.mesh\n"
        "import repro_torch.models.sharding\n"
        "import repro_torch.models.ssd, repro_torch.models.rglru\n"
        "import repro_torch.configs.mamba2_2_7b\n"
        "import repro_torch.configs.recurrentgemma_9b\n"
        "import repro_torch.configs.granite_3_8b\n"
        "import repro_torch.models.moe, repro_torch.configs.mixtral_8x22b\n"
        "import repro_torch.configs.deepseek_v3_671b\n"
        "import repro_torch.configs.whisper_small\n"
        "import repro_torch.configs.paligemma_3b\n"
        "import repro_torch.envs.gomoku, repro_torch.envs.policy_net\n"
        "import repro_torch.sim.server, repro_torch.sim.cache\n"
        "import repro_torch.configs.gomoku_cfg, repro_torch.configs.pong\n"
        "import repro_torch.optim, repro_torch.optim.compression\n"
        "import repro_torch.data, repro_torch.distributed\n"
        "import repro_torch.launch.specs, repro_torch.launch.train\n"
        "import repro_torch.launch.collectives, repro_torch.launch.dryrun\n"
        "import repro_torch.launch.distributed_init\n"
        "import repro_torch.launch.roofline\n"
        "import repro_torch.pytree\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_serving_import_loads_no_kernel_module():
    """The serving stack and the env capability probes import no kernel
    wrapper: the cuda executor loads the kernels when it is built."""
    code = (
        "import sys\n"
        "import repro_torch.service, repro_torch.envs.device\n"
        "bad = [m for m in sys.modules if m.startswith('repro_torch.kernels')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_sim_import_loads_no_model_module():
    """repro_torch.sim imports the LM pieces lazily: SimServer and the
    cache never pull in the model stack, nor does the policy net."""
    code = (
        "import sys\n"
        "from repro_torch.sim import SimServer, CachedSimBackend\n"
        "bad = [m for m in sys.modules if m.startswith('repro_torch.models')"
        " or m == 'repro_torch.sim.lm']\n"
        "assert not bad, bad\n"
        "import repro_torch.envs.policy_net\n"
        "bad = [m for m in sys.modules if m in ('repro_torch.models.lm', "
        "'repro_torch.models.layers', 'repro_torch.sim.lm')]\n"
        "assert not bad, bad\n"
        "from repro_torch.sim import LMTreeEnv\n"
        "assert 'repro_torch.sim.lm' in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
