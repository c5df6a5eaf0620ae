"""Architecture registry of the port (mirrors repro.configs).

Each arch has its own module exporting CONFIG (the published numbers)
and SMOKE (a reduced config of the same family for CPU tests).  All ten
of the JAX package's archs are ported (``ARCH_IDS``): the dense GQA
archs, mamba2 (SSD), recurrentgemma (RG-LRU with local attention),
mixtral (MoE), deepseek-v3 (MLA, MoE with a shared expert, the MTP head),
whisper-small (the encoder and cross-attention) and paligemma-3b (the
VLM prefix).
The MCTS benchmark configs of the paper itself live in pong.py /
gomoku_cfg.py, outside the registry.
"""

from __future__ import annotations

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


def normalize(arch: str) -> str:
    return CANON.get(arch, arch.replace("-", "_").replace(".", "_"))


def get_config(arch: str, smoke: bool = False):
    mod = importlib.import_module(f"repro_torch.configs.{normalize(arch)}")
    return mod.SMOKE if smoke else mod.CONFIG
