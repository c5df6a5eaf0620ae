"""The benchmark of the PyTorch/CUDA port (repro_torch): one cell a run,
started as `python3 mcts_bench/run.py` (see run.py)."""
