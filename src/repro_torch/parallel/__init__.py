"""Logical-axis sharding (``repro/parallel``): specs, and DTensor
placement on a device mesh."""
from repro_torch.parallel.sharding import (  # noqa: F401
    Ax, MeshPlacement, MeshShape, ParamDecl, ShardingCtx, abstract_params,
    full, init_params, param_bytes, place_tree, tree_pspecs,
)
