"""The plain versions of the kernels (the torch ops of core.intree), as
repro.kernels.ref re-exports the jnp oracles:

  kernels  ==  plain torch ops (this module)   — held bit for bit on the card
  plain    ==  ref_sequential numpy program     — held bit for bit in tests

reroot_plain / write_plain (with root_row_plain) are the re-root's passes
in torch ops, held to core.reroot in the tests.  flash_attention_plain is
models.attention.naive_attention, held against the
JAX package's naive_attention in the tests and against the kernel on the
card to the JAX flash test's tolerances.
"""

from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.reroot import reroot_plain, root_row_plain, write_plain
from repro_torch.kernels.uct_backup import backup_arena_plain
from repro_torch.kernels.uct_select import select_arena_plain

__all__ = ["select_arena_plain", "backup_arena_plain", "flash_attention_plain",
           "root_row_plain", "reroot_plain", "write_plain"]
