"""Hand-written Hopper kernels for the paper's in-tree hot spots.

  csrc/uct_select.cu  — Selection + virtual loss + expansion assignment
  csrc/uct_backup.cu  — BackUp from memoized paths (+ straggler mask)
  uct_select.py / uct_backup.py — validated wrappers, launch counters,
                        plain versions on CPU tensors
  build.py            — nvcc + ctypes loader (builds at first use)
  ops.py              — executor-facing arena wrappers
  ref.py              — the plain versions

Nothing is compiled at import; the CPU tests import every module.
"""
