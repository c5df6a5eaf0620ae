"""Architecture registry of the port (mirrors repro.configs).

Each arch has its own module exporting CONFIG (the published numbers)
and SMOKE (a reduced config of the same family for CPU tests).  All ten
of the JAX package's archs are ported (``ARCH_IDS``): the dense GQA
archs, mamba2 (SSD), recurrentgemma (RG-LRU with local attention),
mixtral (MoE), deepseek-v3 (MLA, MoE with a shared expert, the MTP head),
whisper-small (the encoder and cross-attention) and paligemma-3b (the
VLM prefix).
The MCTS benchmark configs of the paper itself live in pong.py /
gomoku_cfg.py, outside the registry.  ``SHAPES`` are the dry run's
assigned input shapes (launch/dryrun.py), ``cell_supported`` its gate.
"""

from __future__ import annotations

import dataclasses
import importlib

# canonical ids as given in the assignment (dashes/dots)
CANON = {
    "paligemma-3b": "paligemma_3b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "gemma3-12b": "gemma3_12b",
    "starcoder2-3b": "starcoder2_3b",
    "llama3.2-1b": "llama3_2_1b",
    "granite-3-8b": "granite_3_8b",
    "mamba2-2.7b": "mamba2_2_7b",
    "whisper-small": "whisper_small",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "mixtral-8x22b": "mixtral_8x22b",
}

ARCH_IDS = ("llama3_2_1b", "gemma3_12b", "starcoder2_3b", "granite_3_8b",
            "mamba2_2_7b", "recurrentgemma_9b", "deepseek_v3_671b",
            "mixtral_8x22b", "whisper_small", "paligemma_3b")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def normalize(arch: str) -> str:
    return CANON.get(arch, arch.replace("-", "_").replace(".", "_"))


def get_config(arch: str, smoke: bool = False):
    mod = importlib.import_module(f"repro_torch.configs.{normalize(arch)}")
    return mod.SMOKE if smoke else mod.CONFIG


# mostly-local hybrids that run long_500k despite a minority of global
# layers (gemma3 keeps 1-in-6 global layers with a sharded full-length
# KV; the 5-in-6 local layers bound the rest)
LONG_CONTEXT_ALLOW = {"gemma3-12b"}


def cell_supported(cfg, shape: ShapeSpec) -> tuple[bool, str]:
    """Is (arch, shape) a runnable cell?"""
    if (shape.name == "long_500k" and not cfg.supports_long_context()
            and cfg.name not in LONG_CONTEXT_ALLOW):
        return False, "pure full-attention stack: 500k decode out of contract"
    return True, ""
