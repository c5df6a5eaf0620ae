"""The JAX package's examples as entry points of the port, one module
each, with the same names, flags, printed lines and work, plus
``--device`` (default ``cuda``; ``cpu`` runs the plain torch path):

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.service_demo [--client]
    PYTHONPATH=src python -m repro_torch.examples.gomoku_selfplay
    PYTHONPATH=src python -m repro_torch.examples.lm_mcts_decode
    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 20

Where the JAX example names the ``faithful`` executor, its twin runs the
port's default for the device (``default_executor``): the hand-written
kernels (``cuda``) on the card, ``faithful`` on the CPU.
"""

import torch


def default_executor(device) -> str:
    """The in-tree executor an example runs on `device`."""
    return "cuda" if torch.device(device).type == "cuda" else "faithful"


def device_flag(ap) -> None:
    """Add the examples' ``--device`` flag to an ArgumentParser."""
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the hand-written kernels on the "
                         "card; raises without one) or cpu (the plain torch "
                         "path)")
