"""The JAX package's shard-map MoE path on two host devices: test data
for tests/test_torch_launch.py, run as a subprocess whose environment
forces two CPU devices (JAX fixes its device count when it first starts):

    XLA_FLAGS=--xla_force_host_platform_device_count=2 \\
        python tests/moe_shard_map_jax.py OUT.npz

For the SMOKE mixtral and deepseek configs (f32, 4 x 16 tokens, seeded
weights and tokens), OUT.npz holds each arch's weights and tokens, the
dense path's y and aux, the dense aux of the first half of the tokens
alone, and ``_moe_shard_map``'s y and aux on the meshes (data=2, model=1)
and (data=1, model=2) with ``Rules(moe_shard_map=True,
shard_experts=False)``.
"""

import sys

import jax
import numpy as np

from repro import configs
from repro.models import moe, sharding as sh

ARCHS = ("mixtral-8x22b", "deepseek-v3-671b")
MESHES = ((2, 1), (1, 2))
B, S = 4, 16


def main(out: str) -> None:
    assert len(jax.devices()) == 2, jax.devices()
    rules = sh.Rules(moe_shard_map=True, shard_experts=False)
    res = {}
    for i, arch in enumerate(ARCHS):
        cfg = configs.get_config(arch, smoke=True)
        p, _ = moe.init_moe(cfg, jax.random.PRNGKey(i))
        x = np.random.RandomState(i).randn(B, S, cfg.d_model).astype(np.float32)
        for path, leaf in jax.tree_util.tree_leaves_with_path(p):
            name = "/".join(k.key for k in path)
            res[f"{arch}:p:{name}"] = np.asarray(leaf)
        res[f"{arch}:x"] = x
        dense = jax.jit(lambda p, x: moe._moe_dense(cfg, p, x, 1.25))
        y, aux = dense(p, x)
        res[f"{arch}:dense:y"] = np.asarray(y).reshape(B * S, -1)
        res[f"{arch}:dense:aux"] = np.asarray(aux)
        _, aux0 = dense(p, x[: B // 2])
        res[f"{arch}:dense_shard0:aux"] = np.asarray(aux0)
        for shape in MESHES:
            # a Mesh of auto axes (jax.make_mesh's default explicit axes
            # refuse the path's unconstrained scan)
            mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(shape),
                                     ("data", "model"))
            y, aux = jax.jit(lambda p, xf: moe._moe_shard_map(
                cfg, p, xf, 1.25, mesh, rules))(p, x.reshape(B * S, -1))
            tag = f"{arch}:{shape[0]}x{shape[1]}"
            res[f"{tag}:y"] = np.asarray(y)
            res[f"{tag}:aux"] = np.asarray(aux)
    np.savez(out, **res)


if __name__ == "__main__":
    main(sys.argv[1])
