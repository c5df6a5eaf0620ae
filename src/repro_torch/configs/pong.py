"""Paper benchmark a: Atari Pong — F=6, D=9, X=56K (paper §V-A)."""

from repro_torch.core.tree import TreeConfig

TREE = TreeConfig(X=56_000, F=6, D=9, beta=1.0, vl_mode="wu",
                  score_fn="uct", leaf_mode="partial")

# reduced config for CPU smoke tests / quick benchmarks
TREE_SMALL = TreeConfig(X=2048, F=6, D=9, beta=1.0, vl_mode="wu",
                        score_fn="uct", leaf_mode="partial")
