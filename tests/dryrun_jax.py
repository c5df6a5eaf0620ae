"""The JAX package's dry run of one small cell on four host devices: test
data for tests/test_torch_launch.py, run as a subprocess whose
environment forces four CPU devices (JAX fixes its device count when it
first starts):

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/dryrun_jax.py OUT.json

The cell is the SMOKE llama3.2-1b train step (B=8, S=32, blockwise) on
the meshes (data=4, model=1) and (data=1, model=2); OUT.json holds, for
each, the dry run's parsed per-device collective bytes by kind
(``collective_bytes``, loop bodies once) and scaled by the loops' trip
counts (``collectives_scaled``), the result shapes of the all-reduce ops
of the compiled HLO with a tensor result (loop bodies once), and the
bytes of those with a scalar one.
"""

import json
import sys

import jax
import numpy as np

from repro import configs
from repro.launch import collectives, roofline

SHAPE = configs.ShapeSpec("train_tiny", 32, 8, "train")
MESHES = ((4, 1), (1, 2))


def main(out: str) -> None:
    assert len(jax.devices()) == 4, jax.devices()
    # imported after the backend has started: the module sets XLA_FLAGS
    # for 512 devices, which no longer takes effect
    from repro.launch import dryrun

    cfg = configs.get_config("llama3.2-1b", smoke=True)
    res = {}
    for shape in MESHES:
        devs = jax.devices()[: shape[0] * shape[1]]
        mesh = jax.sharding.Mesh(np.array(devs).reshape(shape),
                                 ("data", "model"))
        lowered, _ = dryrun.lower_cell(cfg, SHAPE, mesh)
        hlo = lowered.compile().as_text()
        shapes, scalar = [], 0
        for line in hlo.splitlines():
            m = collectives._OP_RE.search(line)
            if (not m or m.group("op") != "all-reduce"
                    or "all-reduce-done" in line):
                continue
            for dt, dims in collectives._SHAPE_RE.findall(m.group("rtype")):
                if dims:
                    shapes.append([dt, [int(d) for d in dims.split(",")]])
                else:
                    scalar += collectives._BYTES[dt]
        res["x".join(map(str, shape))] = {
            "collective_bytes": collectives.collective_bytes(hlo),
            "collectives_scaled": roofline.scaled_collectives(hlo),
            "all_reduce_shapes": shapes,
            "all_reduce_scalar_bytes": scalar}
    with open(out, "w") as f:
        json.dump(res, f, indent=1)


if __name__ == "__main__":
    main(sys.argv[1])
