"""The plain versions of the kernels (the torch ops of core.intree), as
repro.kernels.ref re-exports the jnp oracles:

  kernels  ==  plain torch ops (this module)   — held bit for bit on the card
  plain    ==  ref_sequential numpy program     — held bit for bit in tests
"""

from repro_torch.kernels.uct_backup import backup_arena_plain
from repro_torch.kernels.uct_select import select_arena_plain

__all__ = ["select_arena_plain", "backup_arena_plain"]
