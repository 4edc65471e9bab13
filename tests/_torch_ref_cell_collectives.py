"""The collectives of the reference's BSS-2 fleet cell, lowered at a
reduced geometry on fake CPU devices (``tests/test_torch_bss2_split.py``
starts it; the device count must be set before JAX starts):

    python _torch_ref_cell_collectives.py ROWS COLS T N DATA MODEL

lowers the trial the way ``lower_bss2_cell`` does
(``repro/core/hybrid.py:627-675``: the fleet of N instances over
``data``, every state leaf whose last dim is the COLS columns over
``model``, the "auto" backend) on a DATA x MODEL mesh of CPU devices, and
prints one JSON list: each collective of the compiled HLO with its kind,
result type and the ``op_name`` XLA recorded for it. Not collected by
pytest (no ``test_`` prefix).
"""
import dataclasses
import json
import os
import re
import sys
from pathlib import Path

ROWS, COLS, T, N, DATA, MODEL = map(int, sys.argv[1:7])
os.environ["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count="
                           f"{DATA * MODEL}")
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

from repro.config import MeshConfig  # noqa: E402
from repro.configs.bss2 import BSS2  # noqa: E402
from repro.core.hybrid import RSTDPConfig, make_experiment  # noqa: E402
from repro.parallel.sharding import ShardingCtx  # noqa: E402

COLL = re.compile(r"=\s*(\S.*?)\s+(all-reduce|collective-permute|all-gather|"
                  r"reduce-scatter|all-to-all)(?:-start)?\(")


def main():
    cfg = dataclasses.replace(BSS2, n_rows=ROWS, n_cols=COLS)
    ecfg = RSTDPConfig(n_inputs=ROWS // 2, n_neurons=COLS,
                       pattern_size=min(24, ROWS // 4), trial_steps=T)
    init, trial, _ = make_experiment(cfg=cfg, ecfg=ecfg, prefix=(N,),
                                     backend="auto")
    mesh = Mesh(np.array(jax.devices()).reshape(DATA, MODEL),
                ("data", "model"))
    ctx = ShardingCtx(mesh=mesh, mesh_cfg=MeshConfig(False))

    def spec_for(leaf):             # lower_bss2_cell's
        shp = leaf.shape
        if len(shp) >= 1 and shp[0] == N:
            sh = ctx.instance_sharding(shp, cols=COLS)
            if sh is not None:
                return sh
        parts = [None] * len(shp)
        if len(shp) >= 1 and shp[-1] == COLS:
            parts[-1] = "model"
        return NamedSharding(mesh, P(*parts))

    state_abs = jax.eval_shape(init, jax.random.PRNGKey(0))
    with mesh:
        fn = jax.jit(lambda s, stim: trial(s, stim),
                     in_shardings=(jax.tree.map(spec_for, state_abs),
                                   NamedSharding(mesh, P())),
                     donate_argnums=(0,))
        txt = fn.lower(state_abs, jax.ShapeDtypeStruct((), jnp.int32)
                       ).compile().as_text()
    out = []
    for line in txt.splitlines():
        m = COLL.search(line)
        if m and "-done(" not in line:
            name = re.search(r'op_name="([^"]*)"', line)
            out.append(dict(kind=m.group(2), type=m.group(1),
                            op_name=name.group(1) if name else None))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
