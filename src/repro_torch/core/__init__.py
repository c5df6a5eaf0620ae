from repro_torch.core.tree import TreeConfig, UCTree, init_tree, NULL
from repro_torch.core.executor import (
    CudaExecutor, InTreeExecutor, ReferenceExecutor, TorchExecutor,
    make_intree_executor,
)
from repro_torch.core.expand import (
    EXPANSION_MODES, ExpansionEngine, HostExpansion, host_expand_phase,
)
from repro_torch.core.mcts import (
    RolloutBackend, StepStats, TreeParallelMCTS, make_executor,
)
from repro_torch.core.state_table import StateTable
from repro_torch.core import fixedpoint, intree, ref_sequential, scoring

__all__ = [
    "TreeConfig", "UCTree", "init_tree", "NULL", "TreeParallelMCTS",
    "RolloutBackend", "StepStats", "InTreeExecutor", "TorchExecutor",
    "CudaExecutor", "ReferenceExecutor", "make_executor",
    "make_intree_executor",
    "EXPANSION_MODES", "ExpansionEngine", "HostExpansion",
    "host_expand_phase",
    "StateTable", "fixedpoint", "intree", "ref_sequential", "scoring",
]
