from repro_torch.serving.batcher import ContinuousBatcher, Request

__all__ = ["ContinuousBatcher", "Request"]
