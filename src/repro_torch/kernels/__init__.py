"""Hand-written Hopper kernels for the paper's in-tree hot spots and the
LM simulation backend's prefill attention.

  csrc/uct_select.cu  — Selection + virtual loss + expansion assignment
  csrc/uct_backup.cu  — BackUp from memoized paths (+ straggler mask)
  csrc/flash_attention.cu — FlashAttention-2 forward (causal, window, GQA)
  uct_select.py / uct_backup.py / flash_attention.py — validated wrappers,
                        launch counters, plain versions on CPU tensors
  build.py            — nvcc + ctypes loader (builds at first use)
  ops.py              — executor-facing arena wrappers
  ref.py              — the plain versions

Nothing is compiled at import; the CPU tests import every module.
"""
