"""Simulation backends of the port: the LM as the paper's simulation
(sim/lm.py).  SimServer and SimCache wait for the NN-serving slice
(ROADMAP.md queue A item 7)."""

from repro_torch.sim.lm import MAXLEN, LMContinuationBackend, LMTreeEnv

__all__ = ["MAXLEN", "LMTreeEnv", "LMContinuationBackend"]
