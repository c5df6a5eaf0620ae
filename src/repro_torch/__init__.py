"""repro_torch — the PyTorch/CUDA port of the repro package.

Mirrors src/repro/ module for module; imports torch and numpy, never jax
or repro.  Entry points run on CUDA unless the caller passes
device="cpu".
"""
