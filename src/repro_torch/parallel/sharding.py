"""Logical-axis sharding, the host part (``repro/parallel/sharding.py``).

Every parameter and activation dimension carries a *logical* axis name;
two rule tables (params vs activations) map logical axes onto mesh axes:

  * params:  FSDP over ``data`` (embed dim) x tensor-parallel over
             ``model`` (ff / heads_out / vocab / expert dims).
  * acts:    batch over the data axes (incl. ``pod`` in multi-pod),
             sequence over ``model``.

The spec builders (``param_pspec`` / ``act_pspec`` / ``instance_pspec``)
return a tuple with one entry a dimension: ``None``
(replicated), a mesh-axis name, or a tuple of names. A one-axis tuple is
normalised to its name, so ``("data",)`` reads ``"data"``, as the
reference's ``PartitionSpec`` prints on current JAX. They read the mesh's
shape and axis names only, so a ``MeshShape`` (a mesh given by shape and
names, no devices) is enough, and ``_pspec``'s divisibility demotion
applies as in the reference: a dimension the mesh axes do not divide
evenly stays replicated.

Placing tensors on a real ``torch.distributed`` ``DeviceMesh`` (DTensor)
is the next slice of the port (``ROADMAP.md``, queue 1, "the mesh"):
``init_params`` and ``ServeEngine`` raise when given one, and
``constrain`` is the identity, as the reference's is without a mesh.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import MeshConfig

MESH_PENDING = ("placing tensors on a DeviceMesh is not ported yet "
                "(ROADMAP.md, queue 1: the mesh, DTensor placement in "
                "init_params)")


class Ax:
    """Logical axis vocabulary."""
    # activation axes
    BATCH = "batch"
    SEQ = "seq"            # activation sequence (CP/SP sharded)
    KV_SEQ = "kv_seq"      # KV-cache sequence
    EMBED_ACT = "embed_act"
    HEADS_ACT = "heads_act"
    VOCAB_ACT = "vocab_act"
    EXPERT_ACT = "expert_act"
    DP_GROUP = "dp_group"  # leading MoE dispatch-group dim
    # param axes
    EMBED = "embed"        # FSDP dim
    FF = "ff"
    HEADS_OUT = "heads_out"
    VOCAB = "vocab"
    EXPERT = "expert"
    # neuromorphic axes (BSS-2 machine model)
    NRN = "neuron"         # synapse columns / neurons
    ROW = "row"            # synapse rows / drivers
    INSTANCE = "instance"  # independent chip instances (batch of networks)
    NONE = None


def _rules(mesh_cfg: MeshConfig):
    data_axes = mesh_cfg.data_axes          # ("data",) or ("pod","data")
    param_rules = {
        Ax.EMBED: "data",                   # FSDP: never crosses pods
        Ax.FF: "model",
        Ax.HEADS_OUT: "model",
        Ax.VOCAB: "model",
        Ax.EXPERT: "model",
        Ax.NRN: "model",
        Ax.ROW: None,
        # buffer-like decls (KV caches, optimizer state aliases, machine state)
        Ax.BATCH: data_axes,
        Ax.KV_SEQ: "model",
        Ax.INSTANCE: data_axes,
    }
    act_rules = {
        Ax.BATCH: data_axes,
        Ax.SEQ: "model",
        Ax.KV_SEQ: "model",
        Ax.EMBED_ACT: None,
        Ax.HEADS_ACT: None,
        Ax.VOCAB_ACT: "model",
        Ax.EXPERT_ACT: "model",
        Ax.DP_GROUP: data_axes,
        Ax.NRN: "model",
        Ax.ROW: None,
        Ax.INSTANCE: data_axes,
    }
    return param_rules, act_rules


@dataclass(frozen=True)
class MeshShape:
    """A mesh given by its shape and axis names only: enough for the spec
    builders, ``dp_size`` and ``model_size``; it places nothing."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        assert len(self.shape) == len(self.axis_names), self


def _norm(r):
    """A rule's mesh axes as one spec entry: a one-axis tuple is its name."""
    if isinstance(r, (tuple, list)):
        r = tuple(r)
        return r[0] if len(r) == 1 else r
    return r


@dataclass
class ShardingCtx:
    """Carries mesh + rules + dtype policy through model code. ``mesh``:
    ``None`` (one device), a ``MeshShape``, or a ``DeviceMesh`` (whose
    placement is not ported yet)."""
    mesh: Optional[Any] = None
    mesh_cfg: MeshConfig = field(default_factory=MeshConfig)
    compute_dtype: Any = torch.float32

    def __post_init__(self):
        self.param_rules, self.act_rules = _rules(self.mesh_cfg)

    # -- mesh shape ----------------------------------------------------------
    def _sizes(self) -> dict:
        m = self.mesh
        names = getattr(m, "axis_names", None) or m.mesh_dim_names
        shape = (m.devices.shape if hasattr(m, "devices")
                 else tuple(m.shape))
        return dict(zip(names, shape))

    @property
    def places(self) -> bool:
        """True when the mesh is a real device mesh (not a ``MeshShape``)."""
        return self.mesh is not None and not isinstance(self.mesh, MeshShape)

    def _axis_size(self, mesh_axis) -> int:
        if self.mesh is None:
            return 1
        sizes = self._sizes()
        if isinstance(mesh_axis, (tuple, list)):
            n = 1
            for a in mesh_axis:
                n *= sizes[a]
            return n
        return sizes[mesh_axis]

    # -- spec builders -------------------------------------------------------
    def _pspec(self, axes, rules, shape=None) -> tuple:
        """Map logical axes -> mesh axes, dropping mappings the dim size
        cannot be evenly split over (e.g. batch=1 long-context cells)."""
        parts = []
        for i, ax in enumerate(axes):
            r = rules.get(ax, None) if ax is not None else None
            if r is not None and shape is not None:
                if shape[i] % self._axis_size(r) != 0:
                    r = None
            parts.append(_norm(r))
        return tuple(parts)

    def param_pspec(self, axes, shape=None) -> tuple:
        return self._pspec(axes, self.param_rules, shape)

    def act_pspec(self, axes, shape=None) -> tuple:
        return self._pspec(axes, self.act_rules, shape)

    def instance_pspec(self, shape, cols: Optional[int] = None) -> tuple:
        """The spec of a machine-state leaf of the BSS-2 fleet
        (``instance_sharding``'s): a leading ``Ax.INSTANCE`` dim over the
        data axes, a trailing synapse-column dim over ``model``, each
        demoted to replicated where it does not divide."""
        axes = [None] * len(shape)
        axes[0] = Ax.INSTANCE
        if cols is not None and len(shape) >= 2 and shape[-1] == cols:
            axes[-1] = Ax.NRN
        return self._pspec(axes, self.act_rules, shape)

    # -- activation constraint ----------------------------------------------
    def constrain(self, x, *axes):
        """The reference's ``with_sharding_constraint`` by logical axes:
        the identity here (no mesh places tensors in this slice)."""
        if self.mesh is not None:
            assert len(axes) == x.ndim, (axes, x.shape)
        return x

    @property
    def dp_size(self) -> int:
        """Number of data-parallel groups (for MoE dispatch grouping)."""
        if self.mesh is None:
            return 1
        sizes = self._sizes()
        n = 1
        for ax in self.mesh_cfg.data_axes:
            n *= sizes[ax]
        return n

    @property
    def model_size(self) -> int:
        if self.mesh is None:
            return 1
        return self._sizes()["model"]

    def cast(self, p):
        """Cast a param to the compute dtype."""
        return p if p.dtype == self.compute_dtype else p.to(
            self.compute_dtype)


# ---------------------------------------------------------------------------
# Declarative parameters
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ParamDecl:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"        # normal | zeros | ones | embed
    scale: Optional[float] = None
    dtype: Any = torch.float32

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_leaves(tree, is_leaf):
    """Leaves of a nested dict in the reference's ``jax.tree`` order
    (sorted keys)."""
    if is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k],
                                                             is_leaf)]
    raise TypeError(f"not a tree node: {type(tree)}")


def tree_map(fn, tree, is_leaf):
    """``fn`` over the leaves of a nested dict, keeping its structure."""
    if is_leaf(tree):
        return fn(tree)
    return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}


def _is_decl(x):
    return isinstance(x, ParamDecl)


def _init_leaf(decl: ParamDecl, generator: torch.Generator):
    """The reference's ``_init_leaf`` rules, drawn on the generator's
    device."""
    if decl.init == "zeros":
        return torch.zeros(decl.shape, dtype=decl.dtype,
                           device=generator.device)
    if decl.init == "ones":
        return torch.ones(decl.shape, dtype=decl.dtype,
                          device=generator.device)
    x = torch.randn(decl.shape, generator=generator, dtype=decl.dtype,
                    device=generator.device)
    if decl.init == "embed":
        return x * 0.02
    # fan-in scaled normal
    fan_in = (decl.shape[0] if len(decl.shape) == 1
              else int(np.prod(decl.shape[:-1])))
    scale = (decl.scale if decl.scale is not None
             else 1.0 / max(fan_in, 1) ** 0.5)
    return x * scale


def init_params(decls, generator: Optional[torch.Generator] = None,
                device=None, ctx: Optional[ShardingCtx] = None):
    """Materialise a tree of ``ParamDecl`` into tensors on ``device``
    (``None``: ``cuda``, raising without a card). Leaves are drawn from
    ``generator`` (default: a CPU generator seeded with 0) in sorted-key
    order, on the generator's device, and moved to ``device``. A ``ctx``
    with a real device mesh raises (its placement is not ported yet)."""
    device = resolve_device(device)
    if ctx is not None and ctx.places:
        raise NotImplementedError(MESH_PENDING)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return tree_map(lambda d: _init_leaf(d, generator).to(device), decls,
                    _is_decl)


def abstract_params(decls):
    """The tree as tensors on the ``meta`` device: shapes and dtypes, no
    allocation."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=d.dtype,
                                          device="meta"), decls, _is_decl)


def param_bytes(decls) -> int:
    return sum(int(np.prod(d.shape)) * d.dtype.itemsize
               for d in tree_leaves(decls, _is_decl))
