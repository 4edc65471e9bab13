"""The host part of the port's sharding (``repro_torch.parallel.sharding``)
against the reference's ``repro.parallel.sharding``.

The spec builders are compared as normalised tuples (a one-axis entry
``("data",)`` reads ``"data"``, as the reference's ``PartitionSpec``
prints on current JAX) for every ``ParamDecl`` of every reduced arch, for
activations and for the BSS-2 instance axis, without a mesh and on mesh
shapes (2, 2), (4, 2), (1, 8), (8, 1) and a multi-pod (2, 2, 2). The
reference's ``ShardingCtx`` is given a stand-in mesh with ``axis_names``
and ``devices = np.empty(shape)``, all its ``_pspec`` reads: this covers
the divisibility demotion that ``tests/test_kernels.py::
test_instance_sharding_demotes_odd_fleets_subprocess`` means to check
(that test's own check compares an unnormalised entry). ``init_params``:
shapes, dtypes, the zeros / ones leaves and the embed / fan-in scales;
``param_bytes``; ``abstract_params`` on ``meta``.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.config import ASSIGNED_ARCHS, MeshConfig, get_arch
from repro.models.transformer import build_model as ref_build
from repro.parallel import sharding as rs
from repro_torch.config import get_arch as port_arch
from repro_torch.models.transformer import build_model
from repro_torch.parallel import sharding as ps

MESHES = [((2, 2), False), ((4, 2), False), ((1, 8), False),
          ((8, 1), False), ((2, 2, 2), True)]


def _norm(spec):
    out = []
    for e in spec:
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            e = e[0] if len(e) == 1 else e
        out.append(e)
    return tuple(out)


def _ctxs(shape, multi_pod):
    cfg = MeshConfig(multi_pod)
    axes = cfg.axes
    ref = rs.ShardingCtx(mesh=SimpleNamespace(
        axis_names=axes, devices=np.empty(shape)), mesh_cfg=cfg)
    port = ps.ShardingCtx(mesh=ps.MeshShape(shape, axes),
                          mesh_cfg=MeshConfig(multi_pod))
    return ref, port


def _ref_leaves(decls):
    import jax
    return jax.tree.leaves(decls, is_leaf=lambda x: isinstance(
        x, rs.ParamDecl))


def _port_leaves(decls):
    return ps.tree_leaves(decls, lambda x: isinstance(x, ps.ParamDecl))


@pytest.mark.parametrize("name", ASSIGNED_ARCHS)
def test_decls_equal_the_reference(name):
    """The same tree of declarations: shapes, axes, init and scale, in
    the reference's leaf order."""
    ref = _ref_leaves(ref_build(get_arch(name).reduced(),
                                rs.ShardingCtx()).decls)
    port = _port_leaves(build_model(port_arch(name).reduced(),
                                    ps.ShardingCtx()).decls)
    assert len(ref) == len(port)
    for r, p in zip(ref, port):
        assert (p.shape, p.axes, p.init, p.scale) == \
            (r.shape, r.axes, r.init, r.scale)
        assert p.dtype == torch.float32


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(
    map(str, m[0])))
@pytest.mark.parametrize("name", ASSIGNED_ARCHS)
def test_param_and_act_specs_equal_the_reference(name, mesh):
    shape, multi_pod = mesh
    rctx, pctx = _ctxs(shape, multi_pod)
    decls_r = ref_build(get_arch(name).reduced(), rs.ShardingCtx()).decls
    decls_p = build_model(port_arch(name).reduced(), ps.ShardingCtx()).decls
    for r, p in zip(_ref_leaves(decls_r), _port_leaves(decls_p)):
        for shp in (None, r.shape):
            want = _norm(rctx.param_pspec(r.axes, shp))
            assert pctx.param_pspec(p.axes, shp) == want, (r, shp)
            assert pctx.act_pspec(p.axes, shp) == _norm(
                rctx.act_pspec(r.axes, shp)), (r, shp)
    assert pctx.dp_size == rctx.dp_size
    assert pctx.model_size == rctx.model_size


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(
    map(str, m[0])))
def test_activation_specs_and_demotion(mesh):
    shape, multi_pod = mesh
    rctx, pctx = _ctxs(shape, multi_pod)
    A = ps.Ax
    for axes, shp in [((A.BATCH, A.SEQ, None), (8, 64, 16)),
                      ((A.BATCH, A.SEQ, None), (1, 64, 16)),
                      ((A.BATCH, A.SEQ, None), (3, 7, 16)),
                      ((A.BATCH, A.KV_SEQ, None, None), (4, 256, 2, 16)),
                      ((A.DP_GROUP, A.EXPERT_ACT, None, None),
                       (2, 8, 4, 64)),
                      ((A.BATCH, None, A.VOCAB_ACT), (2, 1, 503))]:
        assert pctx.act_pspec(axes, shp) == _norm(
            rctx.act_pspec(axes, shp)), (axes, shp)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(
    map(str, m[0])))
@pytest.mark.parametrize("n_inst", [1, 3, 8, 16])
def test_instance_axis_specs(mesh, n_inst):
    """The BSS-2 fleet's instance axis (``instance_sharding``'s spec): a
    fleet that the data axes do not divide is demoted to replicated, the
    column dim likewise over ``model``."""
    shape, multi_pod = mesh
    rctx, pctx = _ctxs(shape, multi_pod)
    A = ps.Ax
    for leaf, cols in [((n_inst, 256, 512), 512), ((n_inst, 512), 512),
                       ((n_inst, 256, 7), 7), ((n_inst, 256), None)]:
        axes = [None] * len(leaf)
        axes[0] = A.INSTANCE
        if cols is not None and leaf[-1] == cols:
            axes[-1] = A.NRN
        want = _norm(rctx._pspec(axes, rctx.act_rules, leaf))
        assert pctx.instance_pspec(leaf, cols) == want, (leaf, cols)
    # the demotion the reference's subprocess test means: 3 instances on
    # a data axis of 2 or 4 stay replicated, 16 are split
    data = int(np.prod([s for s, a in zip(shape, MeshConfig(
        multi_pod).axes) if a != "model"]))
    got = pctx.instance_pspec((n_inst, 256, 512), 512)[0]
    assert (got is None) == (n_inst % data != 0)


def test_no_mesh_is_replicated_and_constrain_is_identity():
    ctx = ps.ShardingCtx()
    assert ctx.param_pspec((ps.Ax.EMBED, ps.Ax.FF), (64, 96)) == (
        "data", "model")
    assert ctx.dp_size == 1 and ctx.model_size == 1
    x = torch.ones(2, 3)
    assert ctx.constrain(x, ps.Ax.BATCH, None) is x


def test_init_params_rules():
    decls = dict(
        z=ps.ParamDecl((4, 5), (None, None), init="zeros"),
        o=ps.ParamDecl((7,), (None,), init="ones"),
        e=ps.ParamDecl((512, 256), (None, None), init="embed"),
        n=ps.ParamDecl((256, 300), (None, None)),
        v=ps.ParamDecl((4, 64, 80), (None, None, None)),
        s=ps.ParamDecl((128, 64), (None, None), scale=0.5),
        b=ps.ParamDecl((10,), (None,), dtype=torch.bfloat16, init="zeros"))
    p = ps.init_params(decls, torch.Generator().manual_seed(0),
                       device="cpu")
    for k, d in decls.items():
        assert tuple(p[k].shape) == d.shape and p[k].dtype == d.dtype, k
    assert torch.equal(p["z"], torch.zeros(4, 5))
    assert torch.equal(p["o"], torch.ones(7))
    # the scales within 5% over a large leaf
    assert abs(p["e"].std().item() / 0.02 - 1) < 0.05
    assert abs(p["n"].std().item() * 256 ** 0.5 - 1) < 0.05
    assert abs(p["v"].std().item() * (4 * 64) ** 0.5 - 1) < 0.05
    assert abs(p["s"].std().item() / 0.5 - 1) < 0.05
    # a seed gives the same draw; another seed another
    q = ps.init_params(decls, torch.Generator().manual_seed(0),
                       device="cpu")
    r = ps.init_params(decls, torch.Generator().manual_seed(1),
                       device="cpu")
    assert all(torch.equal(p[k], q[k]) for k in decls)
    assert not torch.equal(p["n"], r["n"])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(
    map(str, m[0])))
def test_placements_follow_the_specs(mesh):
    """A spec as DTensor placements, one a mesh dim: ``Shard(d)`` where
    the mesh dim names tensor dim ``d`` (on each mesh dim of a tuple
    entry) and has more than one rank, else ``Replicate()``; over every
    decl of every reduced arch (demotion included) and the activation
    specs. ``tree_pspecs`` gives ``MeshPlacement`` leaves, or the spec
    tuples."""
    from torch.distributed.tensor import Replicate, Shard
    ref, port = _ctxs(*mesh)
    names = port.mesh.axis_names
    size = dict(zip(names, port.mesh.shape))
    for spec in [("data", "model"), (None, ("pod", "data")), (None, None),
                 ("model", None, "data")]:
        if any(e not in names for e in spec if isinstance(e, str)):
            continue
        pl = port.placements(spec)
        assert len(pl) == len(names)
        for name, p in zip(names, pl):
            dims = [d for d, e in enumerate(spec) if size[name] > 1 and (
                e == name or (isinstance(e, tuple) and name in e))]
            assert p == (Shard(dims[0]) if dims else Replicate()), (spec, pl)
    for name in ASSIGNED_ARCHS:
        decls = build_model(port_arch(name).reduced(), port).decls
        sh = ps.tree_pspecs(decls, port)
        specs = ps.tree_pspecs(decls, port, as_sharding=False)
        for d, s, sp in zip(_port_leaves(decls),
                            ps.tree_leaves(sh, lambda x: isinstance(
                                x, ps.MeshPlacement)),
                            ps.tree_leaves(specs, lambda x: isinstance(
                                x, tuple))):
            assert sp == port.param_pspec(d.axes, d.shape)
            assert s.mesh is port.mesh
            assert s.placements == port.placements(sp)
            assert s.placements == port.param_sharding(d.axes, d.shape)
    # an activation's placements are the reference's act spec, the
    # sequence over ``model`` where it divides and demoted where not
    for shape in ((8, 16, 4), (8, 15, 4), (8, 1, 4)):
        axes = (ps.Ax.BATCH, ps.Ax.SEQ, None)
        want = _norm(ref.act_pspec(axes, shape))
        assert port.act_sharding(axes, shape) == port.placements(want)
        seq = size["model"] > 1 and shape[1] % size["model"] == 0
        assert (Shard(1) in port.act_sharding(axes, shape)) == seq, shape
    assert ps.ShardingCtx().param_sharding((ps.Ax.EMBED,), (4,)) is None


@pytest.mark.parametrize("name", ASSIGNED_ARCHS)
def test_param_bytes_and_abstract_params(name):
    decls_r = ref_build(get_arch(name).reduced(), rs.ShardingCtx()).decls
    decls_p = build_model(port_arch(name).reduced(), ps.ShardingCtx()).decls
    assert ps.param_bytes(decls_p) == rs.param_bytes(decls_r)
    ab = ps.abstract_params(decls_p)
    leaves = ps.tree_leaves(ab, lambda x: isinstance(x, torch.Tensor))
    assert all(x.device.type == "meta" for x in leaves)
    assert [tuple(x.shape) for x in leaves] == [
        d.shape for d in _ref_leaves(decls_r)]


def test_full_width_qwen_bytes():
    """Path G's parameter bytes: qwen1.5-0.5b at full width in f32."""
    decls = build_model(port_arch("qwen1.5-0.5b"), ps.ShardingCtx()).decls
    # param_count() leaves out the final norm (1,024 weights)
    assert ps.param_bytes(decls) == 4 * (463986688 + 1024)
