"""Build and load the hand-written CUDA kernels (nvcc + ctypes).

Each ``csrc/<name>.cu`` has a plain C interface (``extern "C"`` entry
points that return ``cudaGetLastError()``) and is compiled at first use
into ``_build/`` beside this file (listed in .gitignore), named by a hash of its source and the flags, so a changed
source is rebuilt and an unchanged one is loaded as is.  ``build_all``
starts one nvcc per missing library at once, so a fresh checkout builds
every kernel in the time of the slowest one.

Nothing here runs at import: the CPU tests import every module, and this
module needs nvcc only when a kernel is first launched on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
KERNELS = ("uct_select", "uct_backup", "reroot", "flash_attention")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
# name -> (source, extra nvcc flags) of a library built from another
# kernel's source: chip_smoke.py's copy of the Selection kernel with its
# clock64 stamps compiled in (the wrappers never load it)
VARIANTS = {"uct_select_stamps": ("uct_select", ["-DUCT_SELECT_STAMPS"])}

_loaded: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")
    return str(path)


def library_path(name: str) -> Path:
    source, extra = VARIANTS.get(name, (name, []))
    src = (CSRC / f"{source}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS + extra).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{h}.so"


def _start(name: str):
    """Start nvcc for `name` into a temporary file; returns (proc, tmp, out)."""
    out = library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    source, extra = VARIANTS.get(name, (name, []))
    cmd = [nvcc_path(), *NVCC_FLAGS, *extra, "-o", str(tmp),
           str(CSRC / f"{source}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc, tmp: Path, out: Path) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)            # atomic: a reader never sees half a file
    out.with_suffix(".log").write_text(log)
    return log


def build_all(names=KERNELS) -> dict:
    """Build every missing kernel library, all nvcc processes at once.
    Returns {name: compiler log} for the ones built now."""
    started = {n: _start(n) for n in names if not library_path(n).exists()}
    return {n: _finish(n, *s) for n, s in started.items()}


def load(name: str, entry_points: dict) -> ctypes.CDLL:
    """The loaded library of kernel `name` (built first if missing), with
    each C entry point of ``entry_points`` ({function: argtypes}) typed:
    argtypes as given, int return."""
    if name not in _loaded:
        path = library_path(name)
        if not path.exists():
            _finish(name, *_start(name))
        lib = ctypes.CDLL(str(path))
        for fn_name, argtypes in entry_points.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded[name] = lib
    return _loaded[name]


def check(name: str, rc: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
