"""The LM of the simulation backend, on torch (the dense GQA half of
repro.models: config, layers, attention, lm, prefill/decode steps)."""

from repro_torch.models.config import (
    EncoderConfig, LayerSpec, ModelConfig, active_param_count, param_count,
)

__all__ = ["LayerSpec", "ModelConfig", "EncoderConfig", "param_count",
           "active_param_count"]
