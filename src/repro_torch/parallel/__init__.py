"""Logical-axis sharding (``repro/parallel``): the host part."""
from repro_torch.parallel.sharding import (  # noqa: F401
    Ax, MeshShape, ParamDecl, ShardingCtx, abstract_params, init_params,
    param_bytes,
)
