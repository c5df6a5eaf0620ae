"""Paper benchmark b: Gomoku 6x6 — F=36, D=5, X=48K, expand-all + DNN
simulation (paper §V-A)."""

from repro_torch.core.tree import TreeConfig

TREE = TreeConfig(X=48_000, F=36, D=5, beta=5.0, vl_mode="wu",
                  score_fn="puct", leaf_mode="unexpanded", expand_all=True)

TREE_SMALL = TreeConfig(X=1024, F=36, D=5, beta=5.0, vl_mode="wu",
                        score_fn="puct", leaf_mode="unexpanded",
                        expand_all=True)
