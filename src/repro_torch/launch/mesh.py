"""Device meshes (``repro/launch/mesh.py``).

``make_production_mesh`` and ``make_smoke_mesh`` are functions, so
importing this module touches neither ``torch.distributed`` nor CUDA.
They call ``init_device_mesh``, which
starts the default process group from the environment (``torchrun``'s
``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR``) when none is running yet.

Axes: ``data`` carries batch + FSDP; ``model`` carries TP/CP/EP/vocab;
``pod`` (multi-pod only) carries pure data parallelism.
"""
from __future__ import annotations

import math
import os


def world_size() -> int:
    """The world's size: the running group's, else ``WORLD_SIZE``."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def _make_mesh(shape, axes, device_type):
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(shape), tuple(axes)
    assert len(shape) == len(axes), (shape, axes)
    need, world = math.prod(shape), world_size()
    if world != need:
        raise ValueError(
            f"a {'x'.join(map(str, shape))} mesh over {axes} needs a world "
            f"of {need} ranks; this one has {world}")
    if device_type == "cuda" and "LOCAL_RANK" in os.environ:
        import torch
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(multi_pod: bool = False, device_type: str = "cuda"):
    """16 x 16 over (``data``, ``model``), or 2 x 16 x 16 over (``pod``,
    ``data``, ``model``): a ``ValueError`` naming the world size it needs
    (256 or 512) when the world differs."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device_type)


def make_smoke_mesh(shape=(2, 2), axes=("data", "model"),
                    device_type: str = "cuda"):
    """A mesh of any shape over ``axes`` (tests, one-card runs)."""
    return _make_mesh(shape, axes, device_type)
