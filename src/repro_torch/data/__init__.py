"""The training data of the port (a copy of repro.data)."""

from repro_torch.data.pipeline import Prefetcher, SyntheticTokens

__all__ = ["SyntheticTokens", "Prefetcher"]
