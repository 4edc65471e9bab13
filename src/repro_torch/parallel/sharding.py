"""Logical-axis sharding (``repro/parallel/sharding.py``).

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
evenly stays replicated, so no placement is ever uneven.

On a ``torch.distributed`` ``DeviceMesh`` tensors are DTensors: a spec
becomes DTensor placements (``placements``), ``init_params`` keeps each
rank's shard of the full leaf it draws, and ``constrain`` redistributes
an activation (the reference's ``with_sharding_constraint``). A mesh
changes where tensors live, never what they hold: the model's functions
run on DTensors, DTensor's sharding propagation playing GSPMD's part.
Model code runs inside ``ctx.scope()``, where the plain tensors it makes
(masks, positions, iotas: the same on every rank) count as replicated.

Where the sequence is split over ``model`` (``seq_split``), no product
sees a sequence-split DTensor: each such region runs on plain local
blocks inside ``local_map`` (``split_region``), with the weights and
any gathered activation (attention's k and v, the SSD's chunk states)
brought whole at its edge by DTensor redistributes, which carry the
gradients back to each operand's own placement. Between regions only
elementwise ops, norms over the last dim and residual adds touch the
split activations.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch import resolve_device
from repro_torch.config import MeshConfig


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


class MeshPlacement(NamedTuple):
    """Where a leaf lives on a device mesh: the counterpart of the
    reference's ``NamedSharding``."""
    mesh: Any
    placements: tuple


def full(x):
    """The whole value of ``x``: a DTensor gathered (a collective every
    rank makes), a plain tensor as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


@contextlib.contextmanager
def implicit_replication(on: bool = True):
    """DTensor ops take plain tensors as replicated inside (restoring the
    previous setting on exit, so it nests)."""
    disp = DTensor._op_dispatcher
    prev = disp._allow_implicit_replication
    disp._allow_implicit_replication = prev or on
    try:
        yield
    finally:
        disp._allow_implicit_replication = prev


@dataclass
class ShardingCtx:
    """Carries mesh + rules + dtype policy through model code. ``mesh``:
    ``None`` (one device), a ``MeshShape`` (specs only, no placement) or a
    ``DeviceMesh`` (tensors are placed as DTensors). ``overrides``: the
    reference's knobs; the port reads ``moe_impl`` (``"gspmd"`` for
    ``moe_ffn`` under a mesh, else ``moe_ffn_ep``)."""
    mesh: Optional[Any] = None
    mesh_cfg: MeshConfig = field(default_factory=MeshConfig)
    compute_dtype: Any = torch.float32
    overrides: dict = field(default_factory=dict)

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

    # -- placements on a DeviceMesh -----------------------------------------
    def _names(self) -> tuple:
        return tuple(self._sizes())

    def placements(self, spec) -> tuple:
        """A spec tuple as DTensor placements, one a mesh dim: ``Shard(d)``
        where the mesh dim names tensor dim ``d`` (a tuple entry shards
        the dim on each of its mesh dims, in mesh-dim order: the
        reference's major-to-minor split), else ``Replicate()``. A mesh
        dim of size 1 replicates: a split into one part is the whole."""
        sizes = self._sizes()
        out = []
        for name in self._names():
            pl = Replicate()
            for d, e in enumerate(spec):
                if sizes[name] > 1 and (
                        e == name or (isinstance(e, tuple) and name in e)):
                    pl = Shard(d)
            out.append(pl)
        return tuple(out)

    def param_sharding(self, axes, shape=None) -> Optional[tuple]:
        if self.mesh is None:
            return None
        return self.placements(self.param_pspec(axes, shape))

    def act_sharding(self, axes, shape=None) -> Optional[tuple]:
        if self.mesh is None:
            return None
        return self.placements(self.act_pspec(axes, shape))

    def instance_sharding(self, shape, cols: Optional[int] = None
                          ) -> Optional[tuple]:
        if self.mesh is None:
            return None
        return self.placements(self.instance_pspec(shape, cols))

    @property
    def device(self) -> Optional[torch.device]:
        """The rank's device on a device mesh (its card on ``cuda``)."""
        if not self.places:
            return None
        if self.mesh.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(self.mesh.device_type)

    def place(self, x, placements):
        """``x`` on the mesh with ``placements``: a DTensor redistributed,
        a plain tensor (the full value, the same on every rank) cut to
        this rank's shard with no communication."""
        if isinstance(x, DTensor):
            if tuple(x.placements) == tuple(placements) and \
                    x.device_mesh == self.mesh:
                return x
            return x.redistribute(self.mesh, placements)
        return DTensor.from_local(
            _local_shard(x, self.mesh, placements).to(self.device),
            self.mesh, placements, run_check=False)

    def scope(self):
        """The context model code runs in: under a device mesh, plain
        tensors count as replicated DTensors; else nothing."""
        return (implicit_replication() if self.places
                else contextlib.nullcontext())

    # -- activation constraint ----------------------------------------------
    def constrain(self, x, *axes):
        """``with_sharding_constraint`` by logical axes: a DTensor is
        redistributed to the activation spec, anything else (no mesh, a
        ``MeshShape``, a plain local block inside a ``split_region``)
        passes as it is."""
        if self.mesh is None:
            return x
        assert len(axes) == x.ndim, (axes, x.shape)
        if not isinstance(x, DTensor) or self.mesh.size() == 1:
            return x
        # redistributed even where the placements already match: the
        # backward then brings the gradient back to this layout, which
        # the ops before it were written for (without it torch 2.11
        # refuses, in the backward, to flatten a dim that arrives
        # sharded; ``tests/_torch_lm_mesh.py`` part ``grads``)
        return x.redistribute(self.mesh, self.act_sharding(axes,
                                                           tuple(x.shape)))

    # -- sequence-split regions ----------------------------------------------
    def seq_split(self, shape) -> bool:
        """True where an activation [b, s, ...] of ``shape`` has its
        sequence split over ``model`` on a device mesh: the act rule's
        ``Ax.SEQ``, demoted where ``model`` does not divide ``s``."""
        return (self.places and self.model_size > 1
                and self.act_pspec((Ax.BATCH, Ax.SEQ),
                                   tuple(shape[:2]))[1] is not None)

    def split_region(self, fn, tokens_shape, ins, outs):
        """``fn`` run by ``local_map`` on each rank's plain blocks, for a
        region whose tokens ([b, s]: ``tokens_shape``) lie as the act rule
        places them. ``ins`` / ``outs`` give one kind a tensor argument /
        output (``fn`` returns a tuple):

          ``"seq"``    [b, s or chunks, ...] split like the tokens;
          ``"batch"``  [b, ...] the batch split, whole over ``model`` (an
                       activation gathered at the region's edge);
          ``"whole"``  replicated (a weight gathered);
          ``"pos"``    [s] positions, split over ``model``;
          ``"seq_sum"`` [b, ...] a sum over the sequence's ranks
                       (``Partial()`` over ``model``);
          ``"sum"``    a sum over every token block (``Partial()``
                       wherever the tokens are split).

        A plain tensor argument (the same on every rank) is cut to its
        block first. An input held whole on a mesh dim that splits the
        tokens takes its gradient back as ``Partial()`` there (each rank
        computed its share of the sum), which the edge's redistribute
        reduces onto the operand's own placement. So an output that every
        rank computes alike from such an input must take no gradient.

        ``fn`` runs the same ops on every rank, only its offsets differing
        (a rank's first position, its slice of a gathered tensor): the
        backward's collectives, and those of a remat recompute that stops
        once it has what the backward needs, then pair up across the
        ranks. An input no op of ``fn`` reads on one rank takes no
        gradient there, and the other ranks wait for that rank in its
        edge's reduce (``tests/_torch_lm_mesh.py`` part ``seq``)."""
        tok = self.act_sharding((Ax.BATCH, Ax.SEQ), tuple(tokens_shape[:2]))

        def pl(kind):
            out = []
            for t in tok:
                seq, batch = t == Shard(1), t == Shard(0)
                out.append({
                    "seq": t,
                    "batch": t if batch else Replicate(),
                    "whole": Replicate(),
                    "pos": Shard(0) if seq else Replicate(),
                    "seq_sum": Partial() if seq else t,
                    "sum": Partial() if seq or batch else Replicate(),
                }[kind])
            return tuple(out)

        def grad(kind):
            return tuple(Partial() if isinstance(p, Replicate)
                         and isinstance(t, Shard) else p
                         for p, t in zip(pl(kind), tok))
        in_pl = tuple(pl(k) for k in ins)
        run = local_map(fn, out_placements=tuple(pl(k) for k in outs),
                        in_placements=in_pl,
                        in_grad_placements=tuple(grad(k) for k in ins),
                        device_mesh=self.mesh, redistribute_inputs=True)

        def call(*args):
            assert len(args) == len(ins), (len(args), ins)
            return run(*(a if isinstance(a, DTensor) else self.place(a, p)
                         for a, p in zip(args, in_pl)))
        return call

    @property
    def model_rank(self) -> int:
        """This rank's coordinate on ``model`` (0 without a device
        mesh)."""
        return self.mesh.get_local_rank("model") if self.places else 0

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


def _local_shard(x, mesh, placements):
    """This rank's block of the full tensor ``x`` under ``placements``
    (even splits only: ``_pspec`` demotes the rest): a copy of its own
    when cut, so the full tensor can be freed; ``x`` when replicated."""
    coord = mesh.get_coordinate()
    cut = x
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n = mesh.size(i)
            step = cut.shape[pl.dim] // n
            cut = cut.narrow(pl.dim, coord[i] * step, step)
    return x.contiguous() if cut is x else cut.clone(
        memory_format=torch.contiguous_format)


def init_params(decls, generator: Optional[torch.Generator] = None,
                device=None, ctx: Optional[ShardingCtx] = None):
    """Materialise a tree of ``ParamDecl`` into tensors on ``device``
    (``None``: ``cuda``, raising without a card; under a device mesh the
    rank's device). Leaves are drawn from ``generator`` (default: a CPU
    generator seeded with 0) in sorted-key order, on the generator's
    device, and moved to ``device``.

    With a ``ctx`` on a device mesh every rank draws every *full* leaf in
    the same order and keeps its shard by the decl's placements, so the
    parameters equal the ones drawn without a mesh bit for bit, with no
    communication."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if ctx is not None and ctx.places:
        return tree_map(lambda d: ctx.place(
            _init_leaf(d, generator),
            ctx.param_sharding(d.axes, d.shape)), decls, _is_decl)
    device = resolve_device(device)
    return tree_map(lambda d: _init_leaf(d, generator).to(device), decls,
                    _is_decl)


def place_tree(tree, decls, ctx: ShardingCtx):
    """A tree of tensors (full values, or DTensors) placed on ``ctx``'s
    mesh leaf by leaf by the placements of ``decls`` (a tree of the same
    structure); the tree as it is without a device mesh."""
    if not ctx.places:
        return tree
    if _is_decl(decls):
        return ctx.place(tree, ctx.param_sharding(decls.axes, decls.shape))
    return {k: place_tree(tree[k], decls[k], ctx) for k in decls}


def tree_pspecs(decls, ctx: ShardingCtx, as_sharding: bool = True):
    """The spec tree of a ``ParamDecl`` tree: ``MeshPlacement`` leaves
    (mesh and placements; ``None`` without a mesh) or, with
    ``as_sharding=False``, spec tuples."""
    if as_sharding:
        def fn(d):
            pl = ctx.param_sharding(d.axes, d.shape)
            return None if pl is None else MeshPlacement(ctx.mesh, pl)
    else:
        def fn(d):
            return ctx.param_pspec(d.axes, d.shape)
    return tree_map(fn, decls, _is_decl)


def abstract_params(decls):
    """The tree as tensors on the ``meta`` device: shapes and dtypes, no
    allocation."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=d.dtype,
                                          device="meta"), decls, _is_decl)


def param_bytes(decls) -> int:
    return sum(int(np.prod(d.shape)) * d.dtype.itemsize
               for d in tree_leaves(decls, _is_decl))
