"""The port's LM training pieces against the reference's, on the CPU:
``bundle.loss`` and its gradients, remat, the loss helpers, AdamW / SGD,
the train step with accumulation and the fault-tolerant ``Trainer``.

The reference's parameters (``init_params(PRNGKey(0))``) are carried over
by ``convert.params`` (``tests/_torch_lm.py``), inputs come from numpy
seeds, and the house tolerance is rtol = atol = 1e-4
(``docs/exactness.md``) unless a test says otherwise.
"""
import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import (TOL, assert_tree_close, batch, port_batch, ref_batch,
                       setup, to_np)
from repro.config import ASSIGNED_ARCHS
from repro.config import ShapeConfig as RefShape
from repro.config import get_arch as ref_arch
from repro.models import layers as RL
from repro.models import moe as RM
from repro.parallel.sharding import ParamDecl as RefDecl
from repro.parallel.sharding import ShardingCtx as RefCtx
from repro.parallel.sharding import init_params as ref_init
from repro.train import optimizer as RO
from repro.train.steps import make_train_step as ref_train_step
from repro_torch import convert
from repro_torch.config import ShapeConfig, get_arch
from repro_torch.models import layers as PL
from repro_torch.models import moe as PM
from repro_torch.models.transformer import build_model
from repro_torch.parallel.sharding import ParamDecl, ShardingCtx, init_params
from repro_torch.train import optimizer as PO
from repro_torch.train.steps import make_train_step, value_and_grad
from repro_torch.train.trainer import (SimulatedFailure, Trainer,
                                       TrainerConfig)

SHAPE = ShapeConfig("smoke", 32, 4, "train")
ARCH = get_arch("smollm-360m").reduced()


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _labelled(arch, s, seed=1, b=2):
    out = batch(arch, s, seed=seed, b=b)
    out["labels"] = np.random.default_rng(seed + 100).integers(
        0, arch.vocab, (b, s)).astype(np.int32)
    return out


def _ref_loss_grads(rb, rp, b):
    return jax.jit(jax.value_and_grad(rb.loss))(rp, ref_batch(b))


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ASSIGNED_ARCHS)
def test_loss_and_grads_match_reference(name):
    """Every reduced arch (dense, MoE with its aux loss and capacity drops,
    SSM, hybrid with meta tokens and a sliding window, VLM with patches,
    audio with its label mask): the loss and every gradient leaf, remat
    as the arch says (``"dots"``), against ``jax.value_and_grad``."""
    ra, rb, rp, pa, pb, pp = setup(name)
    assert pa.remat and pa.remat_policy == "dots"
    b = _labelled(ra, 16)
    rl, rg = _ref_loss_grads(rb, rp, b)
    pl_, pg = value_and_grad(pb.loss, pp, port_batch(b))
    np.testing.assert_allclose(float(pl_), float(rl), **TOL)
    assert_tree_close(_np_tree(rg), pg, f"{name} grads")
    for leaf in jax.tree.leaves(pg):
        assert torch.isfinite(leaf).all()


@pytest.mark.parametrize("name", ["smollm-360m", "moonshot-v1-16b-a3b",
                                  "hymba-1.5b", "mamba2-130m",
                                  "hubert-xlarge"])
def test_remat_policies_bit_equal(name):
    """Remat changes memory and time, never the numbers: ``"dots"``,
    ``"full"`` and no remat give the same loss and gradients bit for bit
    on the CPU."""
    _, _, _, pa, _, pp = setup(name)
    b = port_batch(_labelled(pa, 16))
    outs = []
    for kw in (dict(remat=False), dict(remat_policy="dots"),
               dict(remat_policy="full")):
        bundle = build_model(dataclasses.replace(pa, **kw), ShardingCtx())
        outs.append(value_and_grad(bundle.loss, pp, b))
    for l, g in outs[1:]:
        assert torch.equal(l, outs[0][0])
        for x, y in zip(jax.tree.leaves(g), jax.tree.leaves(outs[0][1])):
            assert torch.equal(x, y)


def test_ssd_grads_finite_where_the_reference_gives_nan():
    """At an SSD chunk of 128 (mamba2-130m's full chunk is 256) the
    reference's gradients hold NaN: it masks ``exp(cum_i - cum_j)`` after
    the exp (``repro/models/ssm.py:126,149``), the masked entries
    overflow to inf, and their zero cotangent times inf is NaN. The port
    masks inside the exp: the same loss, finite gradients."""
    ra = ref_arch("mamba2-130m").reduced()
    ra = dataclasses.replace(ra, ssm=dataclasses.replace(ra.ssm, chunk=128))
    pa = get_arch("mamba2-130m").reduced()
    pa = dataclasses.replace(pa, ssm=dataclasses.replace(pa.ssm, chunk=128))
    from repro.models.transformer import build_model as ref_build
    rb = ref_build(ra, RefCtx())
    rp = ref_init(rb.decls, jax.random.PRNGKey(0))
    b = _labelled(ra, 128)
    rl, rg = _ref_loss_grads(rb, rp, b)
    assert any(np.isnan(np.asarray(g)).any() for g in jax.tree.leaves(rg))
    pl_, pg = value_and_grad(build_model(pa, ShardingCtx()).loss,
                             convert.params(_np_tree(rp), "cpu"),
                             port_batch(b))
    np.testing.assert_allclose(float(pl_), float(rl), **TOL)
    assert all(torch.isfinite(g).all() for g in jax.tree.leaves(pg))


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="remat_policy"):
        build_model(dataclasses.replace(ARCH, remat_policy="x"),
                    ShardingCtx())


def test_moe_dropped_tokens_get_no_expert_gradient():
    """A capacity factor of 0.25 drops most routed entries: the loss and
    gradients still match the reference's, and a token all of whose top-k
    entries were dropped gets exactly zero gradient from the routed
    experts (no shared expert, aux loss aside)."""
    ra = ref_arch("moonshot-v1-16b-a3b").reduced()
    ra = dataclasses.replace(ra, moe=dataclasses.replace(
        ra.moe, capacity_factor=0.25, n_shared_experts=0))
    pa = get_arch("moonshot-v1-16b-a3b").reduced()
    pa = dataclasses.replace(pa, moe=dataclasses.replace(
        pa.moe, capacity_factor=0.25, n_shared_experts=0))
    rp = ref_init(RM.moe_decls(ra), jax.random.PRNGKey(3))
    pp = convert.params(_np_tree(rp), "cpu")
    x = np.random.default_rng(4).standard_normal((2, 16, 64)).astype(
        np.float32)
    r = np.random.default_rng(5).standard_normal((2, 16, 64)).astype(
        np.float32)

    def ref_fn(p, xx):
        y, aux = RM.moe_ffn(xx, p, ra, RefCtx())
        return jnp.sum(y * r) + 0.0 * aux
    rgp, rgx = jax.jit(jax.grad(ref_fn, argnums=(0, 1)))(rp, jnp.asarray(x))

    xt = torch.from_numpy(x).requires_grad_(True)
    live = {k: v.detach().requires_grad_(True) for k, v in pp.items()}
    y, _ = PM.moe_ffn(xt, live, pa, ShardingCtx())
    (y * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(to_np(xt.grad), np.asarray(rgx), **TOL)
    assert_tree_close(_np_tree(rgp), {k: v.grad for k, v in live.items()},
                      "moe grads")
    # the tokens whose every entry was dropped
    with torch.no_grad():
        logits = xt.reshape(1, 32, 64) @ pp["router"]
        eidx = torch.topk(torch.softmax(logits, -1), pa.moe.top_k, -1)[1]
        eflat = eidx.reshape(1, -1)
        oh = torch.nn.functional.one_hot(eflat, pa.moe.n_experts)
        pos = torch.gather(torch.cumsum(oh, 1) - 1, 2, eflat[..., None])[..., 0]
        C = PM._capacity(32, pa.moe.top_k, pa.moe.n_experts, 0.25)
        dropped = (pos >= C).reshape(32, pa.moe.top_k).all(-1)
    assert dropped.sum() >= 4, int(dropped.sum())
    assert (xt.grad.reshape(32, 64)[dropped] == 0).all()


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_lm_loss_chunked(tied, masked):
    """Several batch chunks (a small ``max_chunk_tokens``) against one,
    and both against the reference's ``lm_loss_chunked``; padded vocab
    columns masked."""
    rng = np.random.default_rng(11)
    b, s, d, v, real = 8, 6, 16, 40, 37
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    w = rng.standard_normal((v, d) if tied else (d, v)).astype(np.float32)
    labels = rng.integers(0, real, (b, s)).astype(np.int32)
    mask = (rng.random((b, s)) < 0.6).astype(np.float32) if masked else None
    tm = None if mask is None else torch.from_numpy(mask)
    outs = [PL.lm_loss_chunked(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(labels), ShardingCtx(),
                               tied=tied, mask=tm, max_chunk_tokens=mct,
                               real_vocab=real)
            for mct in (1 << 18, 12, 6)]      # 1, 4 and 8 chunks
    ref = RL.lm_loss_chunked(jnp.asarray(x), jnp.asarray(w),
                             jnp.asarray(labels), RefCtx(), tied=tied,
                             mask=None if mask is None else jnp.asarray(mask),
                             max_chunk_tokens=12, real_vocab=real)
    for o in outs:
        np.testing.assert_allclose(float(o), float(outs[0]), rtol=1e-6)
        np.testing.assert_allclose(float(o), float(ref), **TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_xent(masked):
    rng = np.random.default_rng(12)
    logits = (rng.standard_normal((3, 5, 30)) * 4).astype(np.float32)
    labels = rng.integers(0, 30, (3, 5)).astype(np.int32)
    mask = (rng.random((3, 5)) < 0.5).astype(np.float32) if masked else None
    p = PL.softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels),
                        None if mask is None else torch.from_numpy(mask))
    r = RL.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                        None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(float(p), float(r), **TOL)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def _decls(make):
    return dict(a=make((4, 3), (None, None)),
                b=dict(c=make((5,), (None,))))


@pytest.mark.parametrize("case", [
    dict(cfg=dict(lr=1e-2, warmup_steps=3), scale=1e-2),       # clip off
    dict(cfg=dict(lr=1e-2, warmup_steps=3), scale=10.0),       # clip binds
    dict(cfg=dict(lr=5e-2, warmup_steps=1, weight_decay=0.3,
                  grad_clip=0.5), scale=1.0),
], ids=["clip_free", "clip_binding", "weight_decay"])
def test_adamw_update_matches_reference(case):
    """Five steps of ``adamw_update`` from the same parameters and
    gradients: parameters, moments, step, grad norm and lr."""
    cfg_r = RO.AdamWConfig(**case["cfg"])
    cfg_p = PO.AdamWConfig(**case["cfg"])
    rp = ref_init(_decls(RefDecl), jax.random.PRNGKey(0))
    ro = ref_init(RO.adamw_init_decls(_decls(RefDecl)), jax.random.PRNGKey(1))
    pp = convert.params(_np_tree(rp), "cpu")
    po = init_params(PO.adamw_init_decls(_decls(ParamDecl)), device="cpu")
    assert po["step"].dtype == torch.int32 and po["step"].ndim == 0
    rng = np.random.default_rng(2)
    for i in range(5):
        g = jax.tree.map(lambda x: (rng.standard_normal(x.shape)
                                    * case["scale"]).astype(np.float32), rp)
        rp, ro, rm = RO.adamw_update(rp, g, ro, cfg_r)
        pp2, po2, pm = PO.adamw_update(pp, convert.params(g, "cpu"), po,
                                       cfg_p)
        assert pp2 is pp and po2 is po          # in place
        assert_tree_close(_np_tree(rp), pp, f"params step {i}")
        assert_tree_close(_np_tree(ro), po, f"opt step {i}")
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(pm[k]), float(rm[k]), **TOL)
    if case["scale"] == 10.0:
        assert float(rm["grad_norm"]) > cfg_r.grad_clip


def test_sgd_update_matches_reference():
    rp = ref_init(_decls(RefDecl), jax.random.PRNGKey(0))
    ro = dict(m=jax.tree.map(jnp.zeros_like, rp), step=jnp.int32(0))
    pp = convert.params(_np_tree(rp), "cpu")
    po = convert.params(_np_tree(ro), "cpu")
    rng = np.random.default_rng(3)
    for _ in range(4):
        g = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
            np.float32), rp)
        rp, ro, _ = RO.sgd_update(rp, g, ro, lr=0.05, momentum=0.8)
        PO.sgd_update(pp, convert.params(g, "cpu"), po, lr=0.05,
                      momentum=0.8)
    assert_tree_close(_np_tree(rp), pp, "params")
    assert_tree_close(_np_tree(ro), po, "opt")


def test_train_step_with_accumulation_matches_reference():
    """``make_train_step(accum_steps=2)`` on the reduced smollm: two steps
    from the reference's parameters on the pipeline's batches. The loss,
    grad norm and moments at the house tolerance. AdamW's first steps
    move each parameter by ~lr * sign(g), so a gradient element within
    rounding of 0 may flip its sign between the packages and move its
    parameter by up to 2 lr: parameters at the house tolerance except
    such elements, counted (|g_ref| < 1e-6) and bounded by 2 lr."""
    from repro.data.pipeline import SyntheticLMPipeline as RefPipe
    from repro_torch.data.pipeline import SyntheticLMPipeline
    ra, rb, rp, pa, pb, pp = setup("smollm-360m")
    pp = convert.params(_np_tree(rp), "cpu")        # updated in place
    opt = dict(lr=1e-3, warmup_steps=2)
    rstep = jax.jit(ref_train_step(rb, RO.AdamWConfig(**opt), 2))
    pstep = make_train_step(pb, PO.AdamWConfig(**opt), 2)
    ro = ref_init(RO.adamw_init_decls(rb.decls), jax.random.PRNGKey(1))
    po = init_params(PO.adamw_init_decls(pb.decls), device="cpu")
    rpipe = RefPipe(ra, RefShape("smoke", 32, 4, "train"), seed=0)
    ppipe = SyntheticLMPipeline(pa, SHAPE, seed=0)
    for i in range(2):
        g_ref = jax.jit(jax.grad(rb.loss))(rp, rpipe.next_batch())
        rpipe.step -= 1
        rp, ro, rm = rstep(rp, ro, rpipe.next_batch())
        pp, po, pm = pstep(pp, po, ppipe.next_batch("cpu"))
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(pm[k]), float(rm[k]), **TOL)
        assert_tree_close(_np_tree(ro["m"]), po["m"], f"m {i}")
        flat_r = jax.tree.leaves(_np_tree(rp))
        flat_p = jax.tree.leaves(pp)
        flat_g = jax.tree.leaves(_np_tree(g_ref))
        near_zero = 0
        for r, p, g in zip(flat_r, flat_p, flat_g):
            err = np.abs(to_np(p) - r)
            bad = err > 1e-4 + 1e-4 * np.abs(r)
            assert (np.abs(g[bad]) < 1e-6).all(), (i, err.max())
            assert (err <= 2 * 1e-3 + 1e-6).all()
            near_zero += int(bad.sum())
        assert near_zero <= 8, near_zero


# ---------------------------------------------------------------------------
# mirrors of tests/test_runtime.py::TestOptimizer and
# TestTrainerFaultTolerance on the port
# ---------------------------------------------------------------------------

class TestOptimizer:
    def test_adamw_minimizes_quadratic(self):
        decls = dict(x=ParamDecl((8,), (None,), init="normal"))
        params = init_params(decls, torch.Generator().manual_seed(0), "cpu")
        opt = init_params(PO.adamw_init_decls(decls), device="cpu")
        cfg = PO.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1)
        target = torch.arange(8.0)
        losses = []
        for _ in range(200):
            loss, g = value_and_grad(
                lambda q, _b: torch.sum((q["x"] - target) ** 2), params,
                None)
            params, opt, _ = PO.adamw_update(params, g, opt, cfg)
            losses.append(float(loss))
        assert losses[-1] < 1e-2 * losses[0]

    def test_grad_clip_bounds_update(self):
        decls = dict(x=ParamDecl((4,), (None,), init="zeros"))
        params = init_params(decls, device="cpu")
        opt = init_params(PO.adamw_init_decls(decls), device="cpu")
        cfg = PO.AdamWConfig(lr=1.0, grad_clip=1.0, warmup_steps=1,
                             weight_decay=0.0)
        g = dict(x=torch.full((4,), 1e6))
        p2, o2, m = PO.adamw_update(params, g, opt, cfg)
        assert float(m["grad_norm"]) > 1e5
        assert (p2["x"].abs() < 1.5).all()


class TestTrainerFaultTolerance:
    def _cfg(self, d, **kw):
        return TrainerConfig(steps=8, ckpt_every=4, ckpt_dir=d,
                             log_every=100,
                             opt=PO.AdamWConfig(lr=1e-3, warmup_steps=2),
                             **kw)

    def test_loss_decreases(self):
        with tempfile.TemporaryDirectory() as d:
            tr = Trainer(ARCH, SHAPE, dataclasses.replace(
                self._cfg(d), steps=30), device="cpu")
            losses = [h["loss"] for h in tr.train()["history"]]
            assert losses[-1] < losses[0], (losses[0], losses[-1])

    def test_crash_restart_continues_identically(self):
        """Run A: 8 steps straight. Run B: crash at step 6, restart from
        the step-4 checkpoint in a fresh trainer, finish. The final
        parameters and moments are equal bit for bit (the reference's
        test allows 2e-5)."""
        with tempfile.TemporaryDirectory() as d1, \
                tempfile.TemporaryDirectory() as d2:
            out_a = Trainer(ARCH, SHAPE, self._cfg(d1), device="cpu").train()
            tr_b = Trainer(ARCH, SHAPE, self._cfg(d2, fail_at_step=6),
                           device="cpu")
            with pytest.raises(SimulatedFailure):
                tr_b.train()
            out_b = Trainer(ARCH, SHAPE, self._cfg(d2), device="cpu").train()
            assert [h["step"] for h in out_b["history"]] == [4, 5, 6, 7]
            for k in ("params", "opt"):
                for x, y in zip(jax.tree.leaves(out_a[k]),
                                jax.tree.leaves(out_b[k])):
                    assert torch.equal(x, y), k

    def test_grad_compression_trains(self):
        with tempfile.TemporaryDirectory() as d:
            tr = Trainer(ARCH, SHAPE, dataclasses.replace(
                self._cfg(d), steps=25, grad_compress_bits=8), device="cpu")
            losses = [h["loss"] for h in tr.train()["history"]]
            assert losses[-1] < losses[0]

    def test_accum_matches_full_batch(self):
        with tempfile.TemporaryDirectory() as d1, \
                tempfile.TemporaryDirectory() as d2:
            cfg1 = dataclasses.replace(self._cfg(d1), steps=3)
            cfg2 = dataclasses.replace(self._cfg(d2), steps=3, accum_steps=2)
            o1 = Trainer(ARCH, SHAPE, cfg1, device="cpu").train(resume=False)
            o2 = Trainer(ARCH, SHAPE, cfg2, device="cpu").train(resume=False)
            l1 = [h["loss"] for h in o1["history"]]
            l2 = [h["loss"] for h in o2["history"]]
            np.testing.assert_allclose(l1, l2, rtol=2e-3)


def test_trainer_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(ARCH, SHAPE, TrainerConfig(steps=1))
