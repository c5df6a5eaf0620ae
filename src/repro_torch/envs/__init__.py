"""Host environments (numpy halves of repro.envs)."""

from repro_torch.envs.bandit_tree import BanditTreeEnv, BanditValueBackend
from repro_torch.envs.ponglite import PongLiteEnv
from repro_torch.envs.gomoku import GomokuEnv, GomokuRolloutBackend
from repro_torch.envs.vector import (
    PoolVectorEnv, VectorEnv, has_async_step, has_fused_step, has_vector_env,
)

__all__ = ["BanditTreeEnv", "BanditValueBackend", "PongLiteEnv", "GomokuEnv",
           "GomokuRolloutBackend", "PoolVectorEnv", "VectorEnv",
           "has_async_step", "has_fused_step", "has_vector_env"]
