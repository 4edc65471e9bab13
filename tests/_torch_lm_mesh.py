"""One rank of the LM mesh checks (``tests/test_torch_lm_mesh.py`` starts
them): ``python _torch_lm_mesh.py RANK WORLD STORE_FILE [gloo|nccl]
[part] [DATA_DIR]``.

Each rank joins a process group through a file store (gloo on the CPU,
the default; nccl on card ``RANK``, one card a rank), builds its mesh
with ``repro_torch.launch.mesh.make_smoke_mesh`` ((WORLD / 2, 2) over
``data``, ``model``; (1, 1) for a world of one) and checks its part:

  place     ``init_params`` under the mesh: each leaf on its decl's
            placements (demoted dims ``Replicate()``), whole value equal
            to the no-mesh draw bit for bit;
  families  logits and loss of six reduced archs (dense, SSM, hybrid,
            vision prefix, audio) under the mesh against the port
            without one (and against the reference's, given DATA_DIR);
  moe       ``moe_ffn_ep`` and the ``"gspmd"`` ``moe_ffn`` under the
            mesh: output, aux loss and gradients (against the
            reference's on a fake-device mesh of the same shape, given
            DATA_DIR; else against ``moe_ffn`` without a mesh);
  serve     ``ServeEngine`` under the mesh: greedy tokens equal the
            no-mesh engine's; handed all-``Replicate()`` parameters it
            runs prefill and decode on the decl placements;
  ops       the loss head (``lm_loss_chunked``, tied and untied) under
            the mesh: value and gradients within 1e-4 of no mesh's;
            prints the gradient error of DTensor's own log-sum-exp over
            a vocab-sharded dim (the fault the head steers round: large
            on torch 2.11 with both mesh dims above 1, not asserted);
  grads     the loss's gradients under the mesh against no mesh, leaf
            by leaf (the worst printed), within 1e-4 of each leaf's
            largest entry;
  train     3 ``Trainer`` steps with 8-bit error feedback under the mesh
            against no mesh; its checkpoint resumed by a trainer on a
            (WORLD, 1) mesh; remat "dots" / "full" / off equal under it;
  reshard   a checkpoint written under the mesh restored under a
            (WORLD, 1) mesh, bit for bit on the new placements (and one
            the reference wrote, given DATA_DIR);
  reshard2  (a world of 2) that checkpoint restored under (1, 2);
  launch    ``make_production_mesh`` refusing this world with the size it
            needs; ``launch/train.py --mesh smoke`` training (AdamW and
            hybrid); ``HybridReadoutTrainer`` under the mesh against no
            mesh with the same injected draws;
  seq       the sequence split over ``model`` on a (1, WORLD) mesh: the
            six families and the reduced moonshot at SEQ_TOTAL positions
            (hymba's meta tokens and the VLM's patches inside them; the
            SSD's chunks and hymba's window blocks cross the ranks):
            logits, loss and every parameter's gradient against no mesh
            (and the reference's, given DATA_DIR), the prefill's KV cache
            and SSM state and greedy tokens against no mesh, and the
            block-boundary activation, q, k, v and the SSD's chunk tensors
            ``Shard`` on the sequence dim over ``model``;
  all       every part above but reshard2 (those that read the
            reference's numbers last);
  full      (four cards) moonshot-v1-16b-a3b at full width served on a
            (1, 4) mesh, smollm-360m training on (2, 2) against one card,
            then ``full_seq`` (``part_full``);
  full_seq  (four cards) smollm-360m training and qwen1.5-0.5b prefill at
            8 x 4096 on (1, 4) against one card: losses, logits, ms and
            each card's peak memory (``part_full_seq``).

DATA_DIR holds the checkpoint the ranks share and, where the test wrote
them, the reference's numbers (the test imports JAX; this file imports
none, so it runs on a machine without JAX: the card's). While a
``PENDING`` file is there, the parts that read them wait for ``READY``.
PART may name several parts, joined by commas. Prints ``LM_MESH_OK
rank=R part=P checks=N``. Not collected by pytest
(no ``test_`` prefix).
"""
import dataclasses
import datetime
import shutil
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import (restore_checkpoint,  # noqa: E402
                                    save_checkpoint)
from repro_torch.config import MoEConfig, ShapeConfig, get_arch  # noqa: E402
from repro_torch.launch import mesh as LM  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMPipeline  # noqa: E402
from repro_torch.models.transformer import (build_model,  # noqa: E402
                                            prefix_len)
from repro_torch.parallel.sharding import (Ax, MeshPlacement,  # noqa: E402
                                           ParamDecl, ShardingCtx, full,
                                           init_params, tree_leaves,
                                           tree_map, tree_pspecs)
from repro_torch.plasticity.three_factor import (  # noqa: E402
    HybridReadoutTrainer, sample_gumbel)
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig  # noqa: E402
from repro_torch.train.steps import value_and_grad  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
FAMILIES = ("qwen1.5-0.5b", "smollm-360m", "mamba2-130m", "hymba-1.5b",
            "internvl2-2b", "hubert-xlarge")
ARCHS = FAMILIES + ("moonshot-v1-16b-a3b",)
SEQ, BATCH = 32, 2
# the seq part's positions: a multiple of 4 ranks x the reduced SSD chunk
# (16); hymba's window (8) then ends a block at each rank boundary
SEQ_TOTAL = 64
TRAIN_SHAPE = ShapeConfig("smoke", 32, 4, "train")
TRAIN_OPT = AdamWConfig(lr=1e-3, warmup_steps=2)


def moe_arch():
    """The reduced moonshot of ``tests/test_moe_ep.py``: d_model 32, 8
    experts top-2, one shared, capacity factor 8 (no token dropped)."""
    return dataclasses.replace(
        get_arch("moonshot-v1-16b-a3b").reduced(), d_model=32,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=16,
                      n_shared_experts=1, capacity_factor=8.0))


def family_batch(arch, seed=1):
    """Numpy inputs with labels: frames for the encoder, patch
    embeddings beside the tokens for the VLM."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, arch.vocab, (BATCH, SEQ)).astype(np.int32)
    if arch.family == "audio":
        return dict(frames=rng.standard_normal(
            (BATCH, SEQ, arch.frame_dim)).astype(np.float32), labels=labels)
    out = dict(tokens=rng.integers(0, arch.vocab, (BATCH, SEQ)).astype(
        np.int32), labels=labels)
    if arch.vit_dim:
        out["patch_embeds"] = rng.standard_normal(
            (BATCH, arch.n_patches, arch.vit_dim)).astype(np.float32)
    return out


def seq_batch(arch, seed=2):
    """Numpy inputs of SEQ_TOTAL positions, the prefix (meta tokens,
    patches) included."""
    rng = np.random.default_rng(seed)
    s = SEQ_TOTAL - prefix_len(arch)
    labels = rng.integers(0, arch.vocab, (BATCH, s)).astype(np.int32)
    if arch.family == "audio":
        return dict(frames=rng.standard_normal(
            (BATCH, s, arch.frame_dim)).astype(np.float32), labels=labels)
    out = dict(tokens=rng.integers(0, arch.vocab, (BATCH, s)).astype(
        np.int32), labels=labels)
    if arch.vit_dim:
        out["patch_embeds"] = rng.standard_normal(
            (BATCH, arch.n_patches, arch.vit_dim)).astype(np.float32)
    return out


def flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def unflatten(flat):
    root = {}
    for key, v in flat.items():
        d = root
        parts = key.split("/")
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return root


def wait_for_reference(data, limit_s=200):
    """Where the test is still writing the reference's numbers into
    ``DATA_DIR`` (a ``PENDING`` file there), wait for its ``READY``."""
    if data is None or not (Path(data) / "PENDING").exists():
        return
    t0 = time.time()
    while not (Path(data) / "READY").exists():
        assert time.time() - t0 < limit_s, "no reference data"
        time.sleep(0.2)


def load(data, name):
    """``(params, rest)`` of ``DATA_DIR/name.npz``: the ``p/...`` keys as
    a numpy tree, the others as they are; ``(None, None)`` without it."""
    wait_for_reference(data)
    if data is None or not (Path(data) / f"{name}.npz").exists():
        return None, None
    with np.load(Path(data) / f"{name}.npz") as z:
        flat = {k: z[k] for k in z.files}
    params = unflatten({k[2:]: v for k, v in flat.items()
                        if k.startswith("p/")})
    return params, {k: v for k, v in flat.items() if not k.startswith("p/")}


def close(got, want, what, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=what, **(tol or TOL))


def to_np(x):
    return full(x).detach().cpu().numpy()


# ---------------------------------------------------------------------------
# parts
# ---------------------------------------------------------------------------

def part_place(ctx, dev, data):
    checks = 0
    for name in ARCHS:
        decls = build_model(get_arch(name).reduced(), ctx).decls
        plain = init_params(decls, torch.Generator().manual_seed(0), dev)
        placed = init_params(decls, torch.Generator().manual_seed(0),
                             ctx=ctx)
        for d, p, m in zip(tree_leaves(decls, _is_decl),
                           tree_leaves(plain, _is_tensor),
                           tree_leaves(placed, _is_tensor)):
            assert isinstance(m, DTensor), name
            assert tuple(m.placements) == ctx.param_sharding(d.axes,
                                                             d.shape), name
            assert torch.equal(m.full_tensor(), p), (name, d)
            checks += 1
    # a dim the mesh does not divide stays replicated; one it does is cut
    odd = dict(a=ParamDecl((3, 64), (Ax.EMBED, Ax.FF)),
               b=ParamDecl((64, 6), (Ax.EMBED, Ax.FF)))
    got = init_params(odd, torch.Generator().manual_seed(5), ctx=ctx)
    ref = init_params(odd, torch.Generator().manual_seed(5), dev)
    n = dict(zip(ctx._names(), ctx.mesh.shape))
    for k, (dd, dm) in dict(a=(3, 64), b=(64, 6)).items():
        want = ctx.placements(((
            "data" if dd % n["data"] == 0 else None),
            ("model" if dm % n["model"] == 0 else None)))
        assert tuple(got[k].placements) == want, (k, got[k].placements)
        assert torch.equal(got[k].full_tensor(), ref[k]), k
        checks += 1
    if n["data"] > 1:
        assert got["a"].placements[0] == Replicate()
    return checks


def _is_decl(x):
    return isinstance(x, ParamDecl)


def _is_tensor(x):
    return isinstance(x, torch.Tensor)


def _is_placement(x):
    return isinstance(x, MeshPlacement)


def part_families(ctx, dev, data):
    checks = 0
    for name in FAMILIES:
        arch = get_arch(name).reduced()
        b0 = build_model(arch, ShardingCtx())
        bm = build_model(arch, ctx)
        params, ref = load(data, f"fam_{name}")
        if params is None:
            p0 = init_params(b0.decls, torch.Generator().manual_seed(0), dev)
            pm = init_params(bm.decls, torch.Generator().manual_seed(0),
                             ctx=ctx)
            batch_np = family_batch(arch)
        else:
            p0 = convert.params(params, dev)
            pm = convert.params(params, ctx=ctx, decls=bm.decls)
            batch_np = {k[2:]: v for k, v in ref.items()
                        if k.startswith("b/")}
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
        if arch.family != "audio":
            lg0 = b0.forward(p0, batch)[0]
            lgm = bm.forward(pm, batch)[0]
            close(to_np(lgm), to_np(lg0), f"{name} logits vs no mesh")
            if ref is not None:
                close(to_np(lgm), ref["logits"], f"{name} logits vs ref")
            checks += 1
        l0 = float(b0.loss(p0, batch))
        lm = float(full(bm.loss(pm, batch)))
        close(lm, l0, f"{name} loss vs no mesh")
        if ref is not None:
            close(lm, ref["loss"], f"{name} loss vs ref")
        checks += 1
    return checks


def part_moe(ctx, dev, data):
    arch = moe_arch()
    decls = M.moe_decls(arch)
    params, ref = load(data, "moe")
    if params is None:
        params = tree_map(lambda t: t.numpy(), init_params(
            decls, torch.Generator().manual_seed(0), "cpu"), _is_tensor)
        x_np = np.random.default_rng(1).standard_normal(
            (4, 8, arch.d_model)).astype(np.float32)
    else:
        x_np = ref["x"]
    x = torch.from_numpy(x_np).to(dev)
    checks = 0
    for impl, fn in (("ep", M.moe_ffn_ep), ("gspmd", M.moe_ffn)):
        pm = convert.params(params, ctx=ctx, decls=decls)
        xm = ctx.place(x, ctx.act_sharding((Ax.BATCH, Ax.SEQ, None),
                                           tuple(x.shape)))
        live = {k: tree_map(lambda t: t.detach().requires_grad_(True), v,
                            _is_tensor) for k, v in pm.items()}
        with ctx.scope(), torch.enable_grad():
            y, aux = fn(xm, live, arch, ctx)
            loss = torch.sum(y ** 2) + aux
            loss.backward()
        grads = tree_map(lambda t: to_np(t.grad), live, _is_tensor)
        y, aux = to_np(y), to_np(aux)
        assert np.isfinite(y).all() and np.isfinite(aux)
        gflat = flatten(grads)
        assert all(np.isfinite(g).all() for g in gflat.values())
        assert sum(float(np.abs(g).sum()) for g in gflat.values()) > 0
        if ref is not None:
            close(y, ref[f"y_{impl}"], f"moe {impl} y")
            close(aux, ref[f"aux_{impl}"], f"moe {impl} aux",
                  rtol=1e-5, atol=1e-5)
            for k, g in gflat.items():
                close(g, ref[f"g_{impl}/{k}"], f"moe {impl} grad {k}")
        else:
            p0 = convert.params(params, dev)
            y0, _ = M.moe_ffn(x, p0, arch, ShardingCtx())
            close(y, to_np(y0), f"moe {impl} y vs no mesh")
        checks += 1
    return checks + _moe_impl_in_the_model(ctx, dev)


def _moe_impl_in_the_model(ctx, dev):
    """``build_model`` under the mesh takes ``moe_ffn_ep`` by default and
    ``moe_ffn`` with ``overrides={"moe_impl": "gspmd"}`` (each counted at
    its call); both give the no-mesh logits (capacity factor 8: no token
    dropped, so the dispatch groups do not change the value)."""
    arch = moe_arch()
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in family_batch(arch).items()}
    b0 = build_model(arch, ShardingCtx())
    lg0 = to_np(b0.forward(init_params(
        b0.decls, torch.Generator().manual_seed(0), dev), batch)[0])
    calls = dict(ep=0, gspmd=0)

    def counted(fn, impl):
        def run(*a, **k):
            calls[impl] += 1
            return fn(*a, **k)
        return run
    ep, gspmd = M.moe_ffn_ep, M.moe_ffn
    M.moe_ffn_ep, M.moe_ffn = counted(ep, "ep"), counted(gspmd, "gspmd")
    try:
        for impl, over in (("ep", {}), ("gspmd", {"moe_impl": "gspmd"})):
            c = ShardingCtx(mesh=ctx.mesh, overrides=over)
            bm = build_model(arch, c)
            before = dict(calls)
            lgm = bm.forward(init_params(
                bm.decls, torch.Generator().manual_seed(0), ctx=c), batch)[0]
            close(to_np(lgm), lg0, f"moe arch logits, {impl}, vs no mesh")
            n_moe = sum("moe" in bm.decls[f"layer_{i}"]
                        for i in range(arch.n_layers))
            assert n_moe and calls[impl] - before[impl] == n_moe, (impl,
                                                                    calls)
            other = "gspmd" if impl == "ep" else "ep"
            assert calls[other] == before[other], (impl, calls)
    finally:
        M.moe_ffn_ep, M.moe_ffn = ep, gspmd
    return 2


def part_serve(ctx, dev, data):
    checks = 0
    prompts = torch.from_numpy(np.random.default_rng(3).integers(
        0, 500, (4, 8)))
    for name in ("qwen1.5-0.5b", "smollm-360m"):
        arch = get_arch(name).reduced()
        e0 = ServeEngine(arch, max_len=32, device=dev)
        p0 = init_params(e0.bundle.decls, torch.Generator().manual_seed(0),
                         dev)
        want = e0.generate(p0, prompts, 6)
        em = ServeEngine(arch, ctx, max_len=32)
        rep = (Replicate(),) * ctx.mesh.ndim
        prep = tree_map(lambda t: ctx.place(t, rep), p0, _is_tensor)
        seen = []

        def spy(fn):
            def run(params, *args, **kw):
                seen.append([tuple(x.placements) for x in
                             tree_leaves(params, _is_tensor)])
                return fn(params, *args, **kw)
            return run
        em.bundle.prefill = spy(em.bundle.prefill)
        em.bundle.decode_step = spy(em.bundle.decode_step)
        got = em.generate(prep, prompts, 6)
        assert got.device.type == "cpu" and got.shape == (4, 6), got.shape
        assert torch.equal(got, want), (name, got, want)
        decl_pl = [ctx.param_sharding(d.axes, d.shape)
                   for d in tree_leaves(em.bundle.decls, _is_decl)]
        assert len(seen) == 7 and all(s == decl_pl for s in seen), name
        assert any(any(not isinstance(p, Replicate) for p in pl)
                   for pl in decl_pl)
        checks += 1
    return checks


def part_train(ctx, dev, data):
    arch = get_arch("smollm-360m").reduced()
    with tempfile.TemporaryDirectory() as d:
        tcfg = TrainerConfig(steps=3, ckpt_every=100, ckpt_dir=d,
                             log_every=100, grad_compress_bits=8,
                             opt=TRAIN_OPT)
        o0 = Trainer(arch, TRAIN_SHAPE, tcfg, device=dev).train(resume=False)
        om = Trainer(arch, TRAIN_SHAPE, tcfg, ctx).train(resume=False)
    l0 = [h["loss"] for h in o0["history"]]
    lm = [h["loss"] for h in om["history"]]
    close(lm, l0, "trainer losses", rtol=1e-5, atol=0)
    # AdamW moves each parameter by ~lr a step, so a gradient element
    # within rounding of 0 (or of a quantization step) may move it
    # otherwise: the house tolerance but for a few such elements, each
    # within 2 lr a step
    bad_total = 0
    for p, q in zip(tree_leaves(o0["params"], _is_tensor),
                    tree_leaves(om["params"], _is_tensor)):
        r, g = to_np(p), to_np(q)
        err = np.abs(g - r)
        bad = err > 1e-4 + 1e-4 * np.abs(r)
        assert (err <= 2 * TRAIN_OPT.lr * 3 + 1e-6).all(), err.max()
        bad_total += int(bad.sum())
    assert bad_total <= 8, bad_total
    # the trainer's checkpoint restored elastically: a new trainer on a
    # (WORLD, 1) mesh resumes onto its own placements, every leaf whole
    # equal to the state the (2, 2) trainer wrote
    ckd = Path(data or tempfile.gettempdir()) / "trainer_ckpt"
    tcfg2 = dataclasses.replace(tcfg, steps=2, ckpt_every=2,
                                ckpt_dir=str(ckd))
    if dist.get_rank() == 0:
        shutil.rmtree(ckd, ignore_errors=True)
    dist.barrier()
    out = Trainer(arch, TRAIN_SHAPE, tcfg2, ctx).train(resume=False)
    ctx2 = ShardingCtx(mesh=LM.make_smoke_mesh(
        (dist.get_world_size(), 1), device_type=ctx.mesh.device_type))
    tr2 = Trainer(arch, TRAIN_SHAPE, tcfg2, ctx2)
    st = tr2.restore_or_init()
    assert st["step"] == 2 and tr2.pipeline.step == 2, st["step"]
    sh = tr2.shardings()
    for part in ("params", "opt"):
        for d, a, b in zip(tree_leaves(sh[part], _is_placement),
                           tree_leaves(out[part], _is_tensor),
                           tree_leaves(st[part], _is_tensor)):
            assert b.device_mesh == ctx2.mesh
            assert tuple(b.placements) == d.placements
            assert torch.equal(full(a), full(b))
    # remat "dots" / "full" / off: the same loss and gradients under the
    # mesh, on the trainer's first batch placed as the trainer places it
    tr = Trainer(arch, TRAIN_SHAPE, tcfg, ctx)
    batch = tr.next_batch()
    outs = []
    for remat, policy in ((True, "dots"), (True, "full"), (False, "dots")):
        a = dataclasses.replace(arch, remat=remat, remat_policy=policy)
        b = build_model(a, ctx)
        pm = init_params(b.decls, torch.Generator().manual_seed(0), ctx=ctx)
        loss, grads = value_and_grad(b.loss, pm, batch)
        outs.append((to_np(loss), [to_np(g) for g in
                                   tree_leaves(grads, _is_tensor)]))
    for loss, grads in outs[1:]:
        np.testing.assert_array_equal(loss, outs[0][0])
        for g, g0 in zip(grads, outs[0][1]):
            np.testing.assert_array_equal(g, g0)
    return 2


def part_grads(ctx, dev, data):
    """The loss's gradients under the mesh (the trainer's placed batch)
    against no mesh, leaf by leaf: the largest error over the leaf's
    largest entry, printed for the worst leaves, within 1e-4."""
    arch = get_arch("smollm-360m").reduced()
    tr = Trainer(arch, TRAIN_SHAPE, TrainerConfig(steps=1, ckpt_dir=str(
        Path(tempfile.gettempdir()) / "unused")), ctx)
    placed = tr.next_batch()
    plain = {k: full(v) for k, v in placed.items()}
    b0, bm = build_model(arch, ShardingCtx()), tr.bundle
    p0 = init_params(b0.decls, torch.Generator().manual_seed(0), dev)
    pm = init_params(bm.decls, torch.Generator().manual_seed(0), ctx=ctx)
    l0, g0 = value_and_grad(b0.loss, p0, plain)
    lm, gm = value_and_grad(bm.loss, pm, placed)
    close(to_np(lm), to_np(l0), "loss")
    errs = sorted(
        (float((full(b).float() - a.float()).abs().max()
               / a.float().abs().max().clamp(min=1e-30)), k)
        for k, a, b in zip(sorted(flatten(b0.decls)),
                           tree_leaves(g0, _is_tensor),
                           tree_leaves(gm, _is_tensor)))[::-1]
    if dist.get_rank() == 0:
        print("grad errors, worst leaves: "
              + ", ".join(f"{k} {e:.3e}" for e, k in errs[:6]), flush=True)
    assert errs[0][0] < 1e-4, errs[:6]
    return len(errs)


def part_ops(ctx, dev, data):
    g = torch.Generator().manual_seed(5)
    b, s, d, v = 4, 32, 64, 512
    x, emb = torch.randn(b, s, d, generator=g), torch.randn(v, d, generator=g)
    labels = torch.randint(0, v, (b, s), generator=g).to(dev)
    wts = torch.randn(b, s, generator=g).to(dev)
    lab_m = ctx.place(labels, ctx.act_sharding((Ax.BATCH, None), (b, s)))

    def grads(fn, leaves):
        """``fn``'s value and gradients without a mesh and under it:
        ``leaves`` are (full value, placements) pairs."""
        out = []
        for c in (ShardingCtx(), ctx):
            xs = [(t.to(dev) if c.mesh is None else c.place(t, pl))
                  .detach().requires_grad_(True) for t, pl in leaves]
            with c.scope():
                y = fn(c, *xs)
                y.backward()
            out.append([to_np(y)] + [to_np(t.grad) for t in xs])
        return out

    def rel(got, want):
        return float(np.abs(got - want).max() / np.abs(want).max())

    xpl = ctx.act_sharding((Ax.BATCH, Ax.SEQ, None), (b, s, d))
    checks = 0
    for tied, w, axes in ((True, emb, (Ax.VOCAB, Ax.EMBED)),
                          (False, emb.T.contiguous(), (Ax.EMBED, Ax.VOCAB))):
        ref, got = grads(lambda c, x, w: L.lm_loss_chunked(
            x, w, labels if c.mesh is None else lab_m, c, tied=tied,
            real_vocab=v), [(x, xpl), (w, ctx.param_sharding(axes, w.shape))])
        for a, r in zip(got, ref):
            assert rel(a, r) < 1e-4, (tied, rel(a, r))
        checks += 1

    def lse(c, lg):
        return torch.sum(torch.log(torch.sum(torch.exp(lg), dim=-1)) * wts)
    ref, got = grads(lse, [(torch.randn(b, s, v, generator=g),
                            ctx.act_sharding((Ax.BATCH, None, Ax.VOCAB_ACT),
                                             (b, s, v)))])
    if dist.get_rank() == 0:
        print(f"DTensor log-sum-exp over a vocab-sharded dim: value err "
              f"{rel(got[0], ref[0]):.3e}, gradient err "
              f"{rel(got[1], ref[1]):.3e} (torch {torch.__version__}, mesh "
              f"{tuple(ctx.mesh.shape)})", flush=True)
    return checks


def _ckpt_decls():
    return build_model(get_arch("smollm-360m").reduced(),
                       ShardingCtx()).decls


def part_reshard(ctx, dev, data):
    decls = _ckpt_decls()
    plain = init_params(decls, torch.Generator().manual_seed(0), dev)
    placed = init_params(decls, torch.Generator().manual_seed(0), ctx=ctx)
    ckdir = Path(data or tempfile.gettempdir()) / "mesh_ckpt"
    save_checkpoint(ckdir, 1, dict(params=placed))
    world = dist.get_world_size()
    ctx2 = ShardingCtx(mesh=LM.make_smoke_mesh(
        (world, 1), device_type=ctx.mesh.device_type))
    checks = _restored_equal(ckdir, ctx2, decls, plain)
    wait_for_reference(data)
    if data is not None and (Path(data) / "ref_ckpt").exists():
        step, st = restore_checkpoint(Path(data) / "ref_ckpt", device=dev)
        checks += _restored_equal(Path(data) / "ref_ckpt", ctx, decls,
                                  st["params"])
    return checks


def _restored_equal(ckdir, ctx, decls, want):
    step, st = restore_checkpoint(
        ckdir, shardings=dict(params=tree_pspecs(decls, ctx)))
    assert step == 1
    n = 0
    for d, w, g in zip(tree_leaves(decls, _is_decl),
                       tree_leaves(want, _is_tensor),
                       tree_leaves(st["params"], _is_tensor)):
        assert isinstance(g, DTensor) and g.device_mesh == ctx.mesh
        assert tuple(g.placements) == ctx.param_sharding(d.axes, d.shape)
        assert torch.equal(g.full_tensor().cpu(), w.cpu()), d
        n += 1
    return n


def part_reshard2(ctx, dev, data):
    """A world of 2: the checkpoint the 4-rank world wrote, under
    (1, 2)."""
    decls = _ckpt_decls()
    plain = init_params(decls, torch.Generator().manual_seed(0), dev)
    ctx2 = ShardingCtx(mesh=LM.make_smoke_mesh(
        (1, 2), device_type=ctx.mesh.device_type))
    return _restored_equal(Path(data or tempfile.gettempdir())
                           / "mesh_ckpt", ctx2, decls, plain)


def part_launch(ctx, dev, data):
    from repro_torch.launch import train as train_main
    world = dist.get_world_size()
    for multi, need in ((False, 256), (True, 512)):
        try:
            LM.make_production_mesh(multi_pod=multi,
                                    device_type=ctx.mesh.device_type)
        except ValueError as e:
            assert str(need) in str(e) and str(world) in str(e), str(e)
        else:
            raise AssertionError("a production mesh on a small world")
    with tempfile.TemporaryDirectory() as d:
        out = train_main.main([
            "--arch", "smollm-360m", "--smoke", "--steps", "2",
            "--device", dev.type, "--mesh", "smoke", "--ckpt-dir", d])
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 2 and np.isfinite(losses).all(), losses
    assert isinstance(tree_leaves(out["params"], _is_tensor)[0], DTensor)
    st = train_main.main([
        "--arch", "smollm-360m", "--smoke", "--steps", "2", "--trainer",
        "hybrid", "--device", dev.type, "--mesh", "smoke"])
    assert st.w_q.dtype == torch.int8 and not isinstance(st.w_q, DTensor)
    return 3 + part_hybrid(ctx, dev)


def part_hybrid(ctx, dev):
    """``HybridReadoutTrainer`` under the mesh: the frozen features on the
    placed parameters, the readout update replicated, against no mesh
    with the same injected Gumbel draws."""
    arch = get_arch("smollm-360m").reduced()
    h0 = HybridReadoutTrainer(arch, device=dev)
    hm = HybridReadoutTrainer(arch, ctx)
    params = init_params(h0.bundle.decls, torch.Generator().manual_seed(0),
                         dev)
    batch = SyntheticLMPipeline(arch, TRAIN_SHAPE, seed=0).next_batch(dev)
    n = batch["labels"].numel()
    g = sample_gumbel(torch.Generator().manual_seed(2),
                      (n, arch.vocab_padded)).to(dev)
    outs = []
    for h in (h0, hm):
        st = h.init_state(torch.Generator().manual_seed(1))
        st = st._replace(w_q=torch.from_numpy(np.random.default_rng(4)
                         .integers(-31, 32, st.w_q.shape).astype(
                             np.int8)).to(dev),
                         mean_r=torch.full((), 0.5, device=dev))
        outs.append(h.update(params, st, batch, gumbel=g))
    (w0, r0, m0), (wm, rm, mm) = outs
    assert not isinstance(wm, DTensor)
    close(to_np(wm), to_np(w0), "three-factor w_new", rtol=0,
          atol=1e-4 * float(w0.abs().max()))
    for k in m0:
        close(to_np(mm[k]), to_np(m0[k]), f"three-factor {k}")
    return 1


SPLIT_REGIONS = ("_qkv_block", "_ssd_chunk_block")


def part_seq(ctx, dev, data):
    """The sequence split over ``model`` on a (1, WORLD) mesh, every arch
    of ARCHS at SEQ_TOTAL positions."""
    world = dist.get_world_size()
    cs = ShardingCtx(mesh=LM.make_smoke_mesh((1, world),
                                             device_type=ctx.mesh.device_type))
    split = [p for p in cs.placements((None, "model")) if p != Replicate()]
    assert split == [Shard(1)], split
    seen, checks = {}, 0
    region = cs.split_region

    def spy_region(fn, *a, **k):
        run = region(fn, *a, **k)
        name = getattr(fn, "func", fn).__name__

        def call(*args):
            out = run(*args)
            seen.setdefault(name, []).extend(
                tuple(t.placements) for t in out)
            return out
        return call
    cs.split_region = spy_region
    block = T._block

    def spy_block(*a, **k):
        out = block(*a, **k)
        if isinstance(out[0], DTensor):
            seen.setdefault("block", []).append(tuple(out[0].placements))
        return out
    for name in ARCHS:
        arch = get_arch(name).reduced()
        b0, bm = build_model(arch, ShardingCtx()), build_model(arch, cs)
        params, ref = load(data, f"seq_{name}")
        if params is None:
            params = tree_map(lambda t: t.numpy(), init_params(
                b0.decls, torch.Generator().manual_seed(0), "cpu"),
                _is_tensor)
            batch_np = seq_batch(arch)
        else:
            batch_np = {k[2:]: v for k, v in ref.items()
                        if k.startswith("b/")}
        p0 = convert.params(params, dev)
        pm = convert.params(params, ctx=cs, decls=bm.decls)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
        seen.clear()
        T._block = spy_block
        try:
            if arch.family != "audio":
                lg0 = to_np(b0.forward(p0, batch)[0])
                lgm = to_np(bm.forward(pm, batch)[0])
                close(lgm, lg0, f"{name} logits vs no mesh")
                if ref is not None:
                    close(lgm, ref["logits"], f"{name} logits vs ref")
            l0, g0 = value_and_grad(b0.loss, p0, batch)
            lm, gm = value_and_grad(bm.loss, pm, batch)
        finally:
            T._block = block
        close(to_np(lm), to_np(l0), f"{name} loss vs no mesh")
        if ref is not None:
            close(to_np(lm), ref["loss"], f"{name} loss vs ref")
        for k, a, g in zip(sorted(flatten(b0.decls)),
                           tree_leaves(g0, _is_tensor),
                           tree_leaves(gm, _is_tensor)):
            close(to_np(g), to_np(a), f"{name} grad {k} vs no mesh")
            if ref is not None:
                close(to_np(g), ref[f"g/{k}"], f"{name} grad {k} vs ref")
        # where the split is: every layer's output, and each attention
        # layer's q, k, v and each SSD layer's chunk tensors, Shard(1)
        # over ``model``
        want = dict(block=arch.n_layers, _qkv_block=3 * arch.n_layers
                    * bool(arch.n_heads), _ssd_chunk_block=6 * arch.n_layers
                    * (arch.family in ("ssm", "hybrid")))
        for k, n in want.items():
            got = seen.get(k, [])
            assert len(got) >= n, (name, k, len(got), n)
            assert all(pl == (Replicate(), Shard(1)) for pl in got), (
                name, k, set(got))
        checks += 3
        if arch.is_encoder_only:
            continue
        prompt = {k: v for k, v in batch.items() if k != "labels"}
        _, c0 = b0.prefill(p0, prompt)
        _, cm = bm.prefill(pm, prompt)
        f0, fm = flatten(c0), flatten(cm)
        assert sorted(f0) == sorted(fm) and f0, (name, sorted(fm))
        for k in f0:
            close(to_np(fm[k]), to_np(f0[k]), f"{name} prefill cache {k}")
        kv = [v for k, v in fm.items() if "/kv/" in k]
        assert all(v.placements == (Replicate(), Shard(1)) for v in kv), name
        toks = batch["tokens"]
        n_new = 3
        e0 = ServeEngine(arch, max_len=SEQ_TOTAL + 8, device=dev)
        em = ServeEngine(arch, cs, max_len=SEQ_TOTAL + 8)
        want_t = e0.generate(p0, toks, n_new)
        got_t = em.generate(pm, toks, n_new)
        assert torch.equal(got_t, want_t), (name, got_t, want_t)
        checks += 2
    return checks


def _timed_steps(tr, n):
    """``n`` steps of ``tr.train()`` from its initial state, each step
    between CUDA events: (losses, ms a step after the first)."""
    step_fn, ev = tr.step_fn, []

    def timed(*args):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = step_fn(*args)
        e1.record()
        ev.append((e0, e1))
        return out
    tr.step_fn = timed
    out = tr.train(resume=False)
    torch.cuda.synchronize()
    return ([h["loss"] for h in out["history"]],
            [a.elapsed_time(b) for a, b in ev[1:]])


def part_full(ctx, dev, data):
    """Four cards (NCCL): moonshot-v1-16b-a3b at full width (48 layers, 64
    experts top-6; 112 GB in f32, 28 GB a card) served on a (1, 4) mesh
    with ``moe_ffn_ep``: 8 x 128 prompt tokens, 16 greedy new ones,
    prefill ms, decode ms a token and each card's peak memory. The
    parameters are drawn on each rank's card from a seeded CUDA generator
    (the same seed on every rank: the same full leaves, with no
    communication). Then smollm-360m at full width, 8 x 512, 3 training
    steps on the (2, 2) mesh against one card alone: losses, step ms.
    Rank 0 prints ``mesh_full_serve`` and ``mesh_full_train`` JSON
    lines."""
    import json
    from repro_torch.obs.timing import PhaseTimer
    rank, world = dist.get_rank(), dist.get_world_size()
    assert world == 4 and dev.type == "cuda", (world, dev)
    rec = {}
    arch = get_arch("moonshot-v1-16b-a3b")
    ctx14 = ShardingCtx(mesh=LM.make_smoke_mesh((1, 4), device_type="cuda"))
    eng = ServeEngine(arch, ctx14, max_len=128 + 16)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = init_params(eng.bundle.decls,
                         torch.Generator(dev).manual_seed(0), ctx=ctx14)
    torch.cuda.synchronize()
    rec["init_s"] = time.time() - t0
    rec["resident_bytes"] = torch.cuda.memory_allocated()
    prompts = np.random.default_rng(23).integers(0, arch.vocab, (8, 128))
    eng.generate(params, prompts[:, :8], n_new=2)              # warm-up
    timer = PhaseTimer(dev)
    out = eng.generate(params, prompts, n_new=16, timer=timer)
    assert out.shape == (8, 16) and int(out.max()) < arch.vocab
    rec["prefill_ms"] = timer.samples["prefill"][0] * 1e3
    rec["decode_ms_per_token"] = timer.samples["decode"][0] * 1e3 / 16
    peaks = [None] * world
    dist.all_gather_object(peaks, torch.cuda.max_memory_allocated())
    rec["peak_bytes_per_card"] = peaks
    same = [None] * world
    dist.all_gather_object(same, out.numpy().tolist())
    assert all(s == same[0] for s in same), "ranks returned other tokens"
    if rank == 0:
        print("mesh_full_serve " + json.dumps(rec), flush=True)
    del params, eng
    torch.cuda.empty_cache()
    rec = {}

    arch = get_arch("smollm-360m")
    shape = ShapeConfig("train_small", 512, 8, "train")
    with tempfile.TemporaryDirectory() as d:
        tcfg = TrainerConfig(steps=3, ckpt_every=100, ckpt_dir=d,
                             log_every=100, opt=TRAIN_OPT)
        rec["train_losses_mesh"], rec["train_step_ms_mesh"] = _timed_steps(
            Trainer(arch, shape, tcfg, ctx), 3)
        torch.cuda.empty_cache()
        if rank == 0:
            rec["train_losses_one_card"], rec["train_step_ms_one_card"] = \
                _timed_steps(Trainer(arch, shape, tcfg, device=dev), 3)
            close(rec["train_losses_mesh"], rec["train_losses_one_card"],
                  "smollm losses, (2, 2) mesh vs one card", rtol=1e-4, atol=0)
    dist.barrier()
    if rank == 0:
        print("mesh_full_train " + json.dumps(rec), flush=True)
    return 2 + part_full_seq(ctx, dev, data)


def _peaks():
    """Every rank's peak allocated bytes since its last reset."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, torch.cuda.max_memory_allocated())
    return out


def part_full_seq(ctx, dev, data):
    """Four cards (NCCL), the sequence over ``model``: smollm-360m at full
    width, 3 training steps at 8 x 4096 (train_4k's sequence) on a (1, 4)
    mesh against one card alone on the same batches (losses, step ms,
    each card's peak memory); qwen1.5-0.5b prefill at 8 x 4096 on (1, 4)
    against one card (the last position's logits, ms, each card's peak
    memory). The parameters are drawn on each card from a seeded CUDA
    generator. The mesh trains with the arch's remat ("dots"), the one
    card with "full". Rank 0 prints a ``mesh_full_seq`` JSON line. The measures
    read the model through its public entry points only, so the helper
    also measures a tree that keeps the sequence whole."""
    import json
    rank, world = dist.get_rank(), dist.get_world_size()
    assert world == 4 and dev.type == "cuda", (world, dev)
    c14 = ShardingCtx(mesh=LM.make_smoke_mesh((1, 4), device_type="cuda"))
    rec = dict(torch=torch.__version__, mesh=[1, 4])
    arch = get_arch("smollm-360m")
    rec["remat_mesh"], rec["remat_one_card"] = arch.remat_policy, "full"
    shape = ShapeConfig("train_4k_b8", 4096, 8, "train")
    with tempfile.TemporaryDirectory() as d:
        tcfg = TrainerConfig(steps=3, ckpt_every=100, ckpt_dir=d,
                             log_every=100, opt=TRAIN_OPT)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rec["train_losses_mesh"], rec["train_step_ms_mesh"] = _timed_steps(
            Trainer(arch, shape, tcfg, c14), 3)
        rec["train_peak_bytes_mesh"] = _peaks()
        torch.cuda.empty_cache()
        if rank == 0:
            # one card holds this batch only with remat "full" (with the
            # arch's "dots" its saved products overflow 80 GB); the
            # policies give the same numbers (part ``train``)
            torch.cuda.reset_peak_memory_stats()
            rec["train_losses_one_card"], rec["train_step_ms_one_card"] = \
                _timed_steps(Trainer(dataclasses.replace(
                    arch, remat_policy="full"), shape, tcfg, device=dev), 3)
            rec["train_peak_bytes_one_card"] = \
                torch.cuda.max_memory_allocated()
            torch.cuda.empty_cache()
    dist.barrier()

    arch = get_arch("qwen1.5-0.5b")
    tokens = torch.from_numpy(np.random.default_rng(27).integers(
        0, arch.vocab, (8, 4096))).to(dev)
    bm = build_model(arch, c14)
    pm = init_params(bm.decls, torch.Generator(dev).manual_seed(0), ctx=c14)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        bm.prefill(pm, dict(tokens=tokens[:, :512]))         # warm-up
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        lgm = full(bm.prefill(pm, dict(tokens=tokens))[0])
        e1.record()
        torch.cuda.synchronize()
    rec["prefill_ms_mesh"] = e0.elapsed_time(e1)
    rec["prefill_peak_bytes_mesh"] = _peaks()
    del pm
    torch.cuda.empty_cache()
    if rank == 0:
        b1 = build_model(arch, ShardingCtx())
        p1 = init_params(b1.decls, torch.Generator(dev).manual_seed(0), dev)
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            b1.prefill(p1, dict(tokens=tokens[:, :512]))
            e0.record()
            lg1 = b1.prefill(p1, dict(tokens=tokens))[0]
            e1.record()
            torch.cuda.synchronize()
        rec["prefill_ms_one_card"] = e0.elapsed_time(e1)
        rec["prefill_peak_bytes_one_card"] = torch.cuda.max_memory_allocated()
        real = slice(0, arch.vocab)          # the padded columns: -1e30
        err = (lgm[..., real].float() - lg1[..., real].float()).abs()
        rec["prefill_logits_max_abs_err"] = float(err.max())
        rec["prefill_logits_max_abs"] = float(
            lg1[..., real].float().abs().max())
        del p1, b1
        torch.cuda.empty_cache()
        print("mesh_full_seq " + json.dumps(rec), flush=True)
        close(rec["train_losses_mesh"], rec["train_losses_one_card"],
              "smollm 8 x 4096 losses, (1, 4) mesh vs one card",
              rtol=1e-4, atol=0)
        close(to_np(lgm), to_np(lg1), "qwen 8 x 4096 prefill logits, (1, 4) "
              "mesh vs one card", rtol=1e-3, atol=1e-3)
    dist.barrier()
    return 2


PARTS = dict(place=part_place, families=part_families, moe=part_moe,
             serve=part_serve, train=part_train, reshard=part_reshard,
             reshard2=part_reshard2, launch=part_launch, grads=part_grads,
             ops=part_ops, seq=part_seq, full=part_full,
             full_seq=part_full_seq)
# the parts that read the reference's numbers last: the test writes them
# while the others run
ALL = ("place", "serve", "ops", "grads", "train", "launch", "families", "moe",
       "reshard", "seq")


def mesh_shape(world):
    return (1, 1) if world == 1 else (world // 2, 2)


def main(rank, world, store, backend="gloo", part="all", data=None):
    if backend == "nccl":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            # the four-card parts hold ranks at a barrier
                            # while rank 0 runs the one-card baseline
                            timeout=datetime.timedelta(
                                seconds=600 if "full" in part else 100),
                            device_id=dev if backend == "nccl" else None)
    ctx = ShardingCtx(mesh=LM.make_smoke_mesh(mesh_shape(world),
                                              device_type=dev.type))
    checks, failed = 0, []
    for p in (ALL if part == "all" else part.split(",")):
        t0 = time.time()
        try:
            n = PARTS[p](ctx, dev, data)
        except Exception:
            # every rank runs the same checks, so they fail together; the
            # group's timeout ends a collective that one rank left
            failed.append(p)
            print(f"part {p} FAILED:\n{traceback.format_exc()}", flush=True)
            continue
        print(f"part {p} checks={n} s={time.time() - t0:.1f}", flush=True)
        checks += n
    dist.destroy_process_group()
    if failed:
        raise SystemExit(f"rank {rank}: parts failed: {failed}")
    print(f"LM_MESH_OK rank={rank} part={part} checks={checks}", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:7])
