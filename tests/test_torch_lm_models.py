"""The port's LM models (``repro_torch.models``) against the reference's
(``repro.models``) on every reduced arch, with the reference's parameters
(``init_params(PRNGKey(0))``) carried over by ``convert.params``, at the
house tolerance rtol = atol = 1e-4 (``docs/exactness.md``):

* ``forward``'s logits and MoE aux;
* each ``_block`` teacher-forced from the reference's input to it;
* ``prefill``'s logits and every cache leaf;
* three chained ``decode_step``s from the reference's grown cache, the
  logits at each and the cache after; for the SSM archs also at 48
  positions, three SSD chunks and six sliding windows.

Then the mirrors of the reference's invariants
(``tests/test_moe_attention_invariants.py``, ``tests/test_models_smoke.py::
test_prefill_matches_decode``, ``tests/test_properties.py::TestRoPE``),
each held inside the port and against the reference's function.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from hypothesis import given, settings
from hypothesis import strategies as st

from _torch_lm import (TOL, assert_tree_close, batch, grow_ref, port_batch,
                       ref_batch, setup, to_np)
from repro.config import ASSIGNED_ARCHS, MoEConfig
from repro.config import get_arch as ref_arch
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models import moe as RM
from repro.models import transformer as RT
from repro.parallel.sharding import ShardingCtx as RefCtx
from repro_torch import convert
from repro_torch.config import MoEConfig as PortMoEConfig
from repro_torch.config import get_arch as port_arch
from repro_torch.models import attention as PA
from repro_torch.models import layers as PL
from repro_torch.models import moe as PM
from repro_torch.models import transformer as PT
from repro_torch.parallel.sharding import ShardingCtx
from repro_torch.parallel.sharding import init_params as port_init
from repro_torch.parallel.sharding import ParamDecl

SERVED = [a for a in ASSIGNED_ARCHS if not ref_arch(a).is_encoder_only]
# prompt lengths: total (prompt + prefix) a multiple of the reduced SSD
# chunk (16) or below it, which a prefill returning a state needs
PROMPT = 12


@pytest.mark.parametrize("name", ASSIGNED_ARCHS)
def test_forward_logits(name):
    ra, rb, rp, pa, pb, pp = setup(name)
    b = batch(ra, 20)
    rl, raux, rmask = jax.jit(rb.forward)(rp, ref_batch(b))
    pl_, paux, pmask = pb.forward(pp, port_batch(b))
    assert pl_.shape == (2, 20 + RT.prefix_len(ra), ra.vocab_padded)
    np.testing.assert_allclose(to_np(pl_), np.asarray(rl), **TOL)
    np.testing.assert_allclose(float(paux), float(raux), **TOL)
    assert (rmask is None) == (pmask is None)
    if rmask is not None:
        np.testing.assert_array_equal(to_np(pmask), np.asarray(rmask))


@pytest.mark.parametrize("name", ASSIGNED_ARCHS)
def test_blocks_teacher_forced(name):
    """Each block fed the reference's input to it: outputs and aux."""
    ra, rb, rp, pa, pb, pp = setup(name)
    b = batch(ra, 16)
    x, _ = jax.jit(lambda p, bb: RT._frontend(p, bb, ra, RefCtx()))(
        rp, ref_batch(b))
    px, _ = PT._frontend(pp, port_batch(b), pa, ShardingCtx())
    np.testing.assert_allclose(to_np(px), np.asarray(x), **TOL)
    pos = jnp.arange(x.shape[1])
    for i in range(ra.n_layers):
        y, aux, _ = jax.jit(lambda xx, pi, _i=i: RT._block(
            xx, pi, ra, _i, RefCtx(), positions=pos))(x, rp[f"layer_{i}"])
        py, paux, _ = PT._block(torch.from_numpy(np.array(x)),
                                pp[f"layer_{i}"], pa, i, ShardingCtx(),
                                positions=torch.arange(x.shape[1]))
        np.testing.assert_allclose(to_np(py), np.asarray(y),
                                   err_msg=f"layer {i}", **TOL)
        np.testing.assert_allclose(float(paux), float(aux), **TOL)
        x = y


@pytest.mark.parametrize("name", ASSIGNED_ARCHS)
def test_prefill_logits_and_cache(name):
    ra, rb, rp, pa, pb, pp = setup(name)
    b = batch(ra, PROMPT)
    rl, rc = jax.jit(rb.prefill)(rp, ref_batch(b))
    pl_, pc = pb.prefill(pp, port_batch(b))
    np.testing.assert_allclose(to_np(pl_), np.asarray(rl), **TOL)
    assert_tree_close(rc, pc, name)
    if ra.is_encoder_only:
        assert pc == {}
    else:
        assert set(pc) == {f"layer_{i}" for i in range(ra.n_layers)}


@pytest.mark.parametrize("name", SERVED)
def test_chained_decode_from_reference_cache(name):
    """Three decode steps from the reference's prefill cache (grown as its
    engine grows it), fed the same tokens: logits at each step and the
    cache after, against the reference's."""
    ra, rb, rp, pa, pb, pp = setup(name)
    b = batch(ra, PROMPT)
    _, rc = jax.jit(rb.prefill)(rp, ref_batch(b))
    total = PROMPT + RT.prefix_len(ra)
    rc = grow_ref(rc, total, total + 3)
    pc = convert.lm_cache(jax.tree.map(np.asarray, rc), "cpu")
    toks = np.random.default_rng(5).integers(0, ra.vocab, (3, 2, 1))
    step = jax.jit(rb.decode_step)
    for i in range(3):
        rl, rc = step(rp, rc, jnp.asarray(toks[i], jnp.int32),
                      jnp.int32(total + i))
        pl_, pc = pb.decode_step(pp, pc, torch.from_numpy(toks[i]),
                                 total + i)
        np.testing.assert_allclose(to_np(pl_), np.asarray(rl),
                                   err_msg=f"step {i}", **TOL)
    assert_tree_close(rc, pc, f"{name} cache after 3 steps")


@pytest.mark.parametrize("name", ["hymba-1.5b", "mamba2-130m"])
def test_prefill_and_decode_over_several_chunks(name):
    """48 positions (prompt + prefix): three reduced SSD chunks of 16, so
    the inter-chunk state pass runs, and six reduced sliding windows of 8.
    The prefill's logits and cache (the SSM state after the pass), then
    three chained decode steps from the reference's grown cache, against
    the reference's."""
    ra, rb, rp, pa, pb, pp = setup(name)
    total = 48
    assert total // ra.ssm.chunk == 3 and total > 2 * (ra.swa_window or 0)
    b = batch(ra, total - RT.prefix_len(ra), seed=7)
    rl, rc = jax.jit(rb.prefill)(rp, ref_batch(b))
    pl_, pc = pb.prefill(pp, port_batch(b))
    np.testing.assert_allclose(to_np(pl_), np.asarray(rl), **TOL)
    assert_tree_close(rc, pc, f"{name} prefill cache")
    rc = grow_ref(rc, total, total + 3)
    pc = convert.lm_cache(jax.tree.map(np.asarray, rc), "cpu")
    toks = np.random.default_rng(8).integers(0, ra.vocab, (3, 2, 1))
    step = jax.jit(rb.decode_step)
    for i in range(3):
        rl, rc = step(rp, rc, jnp.asarray(toks[i], jnp.int32),
                      jnp.int32(total + i))
        pl_, pc = pb.decode_step(pp, pc, torch.from_numpy(toks[i]),
                                 total + i)
        np.testing.assert_allclose(to_np(pl_), np.asarray(rl),
                                   err_msg=f"step {i}", **TOL)
    assert_tree_close(rc, pc, f"{name} cache after 3 steps")


@pytest.mark.parametrize("name", SERVED)
def test_decode_position_as_a_tensor(name):
    """``t`` as a 0-d tensor gives what the int gives."""
    ra, rb, rp, pa, pb, pp = setup(name)
    b = port_batch(batch(ra, PROMPT))
    from repro_torch.serve.engine import grow_cache
    total = PROMPT + PT.prefix_len(pa)
    outs = []
    for t in (total, torch.tensor(total)):
        _, c = pb.prefill(pp, b)
        c = grow_cache(c, total, total + 1)
        outs.append(pb.decode_step(pp, c, torch.ones(2, 1, dtype=torch.long),
                                   t)[0])
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("name", SERVED)
def test_prefill_matches_decode(name):
    """Prefill then one decode step == forward over the extended sequence
    (tests/test_models_smoke.py::test_prefill_matches_decode)."""
    ra, rb, rp, pa, pb, pp = setup(name)
    from repro_torch.serve.engine import grow_cache
    pl_ = PT.prefix_len(pa)
    s = 32 - pl_
    b = port_batch(batch(pa, s))
    _, cache = pb.prefill(pp, b)
    cache = grow_cache(cache, 32, 40)
    tok = torch.full((2, 1), 3, dtype=torch.long)
    ld, _ = pb.decode_step(pp, cache, tok, 32)
    b2 = dict(b, tokens=torch.cat([b["tokens"], tok.to(torch.int32)], 1))
    lf, _, _ = pb.forward(pp, b2)
    # the MoE archs at the reference's own 2e-2: the 66-token forward
    # routes under a capacity that drops tokens, the 2-token decode step
    # under one that drops none
    tol = dict(rtol=2e-2, atol=2e-2) if pa.moe.n_experts else TOL
    np.testing.assert_allclose(to_np(ld[:, 0]), to_np(lf[:, -1]), **tol)


def test_input_specs_match_the_reference():
    from repro.config import SHAPES
    from repro_torch.config import SHAPES as PSHAPES
    for name in ASSIGNED_ARCHS:
        for s in SHAPES:
            r = RT.input_specs(ref_arch(name), SHAPES[s], None)
            p = PT.input_specs(port_arch(name), PSHAPES[s], ShardingCtx())
            assert set(r) == set(p), (name, s)
            for k in r:
                assert tuple(p[k].shape) == r[k].shape, (name, s, k)
                assert p[k].device.type == "meta"
                assert str(p[k].dtype).split(".")[-1] == str(r[k].dtype)


# ---------------------------------------------------------------------------
# Mirrors of the reference's invariants
# ---------------------------------------------------------------------------

def _moe_arch(n_experts=8, top_k=2, cf=8.0):
    return dataclasses.replace(
        port_arch("moonshot-v1-16b-a3b").reduced(), d_model=32,
        moe=PortMoEConfig(n_experts=n_experts, top_k=top_k, d_ff_expert=16,
                          n_shared_experts=0, capacity_factor=cf))


def _ref_moe_arch(arch):
    return dataclasses.replace(
        ref_arch("moonshot-v1-16b-a3b").reduced(), d_model=arch.d_model,
        moe=MoEConfig(**dataclasses.asdict(arch.moe)))


def _moe_params(arch, seed=0):
    return port_init(PM.moe_decls(arch), torch.Generator().manual_seed(seed),
                     device="cpu")


def _ref_moe(x, p, arch):
    rp = {k: jnp.asarray(to_np(v)) for k, v in p.items()}
    ra = _ref_moe_arch(arch)
    y, aux = jax.jit(lambda xx, pp: RM.moe_ffn(xx, pp, ra, RefCtx()))(
        jnp.asarray(to_np(x)), rp)
    return np.asarray(y), float(aux)


class TestMoEDispatch:
    def test_matches_naive_per_token_loop(self):
        arch = _moe_arch()
        p = _moe_params(arch)
        x = torch.randn((2, 8, 32), generator=torch.Generator().manual_seed(1))
        y, aux = PM.moe_ffn(x, p, arch, ShardingCtx())
        probs = torch.softmax(x @ p["router"], -1)
        gates, eidx = torch.topk(probs, arch.moe.top_k)
        gates = gates / gates.sum(-1, keepdim=True)
        y_ref = torch.zeros_like(x)
        for e in range(arch.moe.n_experts):
            h = F.silu(x @ p["we_gate"][e]) * (x @ p["we_up"][e])
            ye = h @ p["we_down"][e]
            for k in range(arch.moe.top_k):
                w = torch.where(eidx[..., k] == e, gates[..., k], 0.0)
                y_ref = y_ref + w[..., None] * ye
        np.testing.assert_allclose(to_np(y), to_np(y_ref), **TOL)
        ry, raux = _ref_moe(x, p, arch)
        np.testing.assert_allclose(to_np(y), ry, **TOL)
        np.testing.assert_allclose(float(aux), raux, **TOL)

    def test_capacity_drops_excess_tokens(self):
        arch = _moe_arch(n_experts=2, top_k=1, cf=0.51)
        p = _moe_params(arch)
        p["router"][:, 0] = 100.0
        p["router"][:, 1] = -100.0
        x = torch.randn((2, 16, 32), generator=torch.Generator().manual_seed(1))
        y, _ = PM.moe_ffn(x, p, arch, ShardingCtx())
        # capacity = max(4, 32*1/2*0.51) = 8 slots an expert for 32 tokens:
        # at most 16 rows keep an output, the rest are dropped to zero
        nz = np.abs(to_np(y)).sum(-1) > 1e-6
        assert 0 < nz.sum() <= 2 * 8
        ry, _ = _ref_moe(x, p, arch)
        np.testing.assert_allclose(to_np(y), ry, **TOL)

    def test_aux_loss_uniform_router_is_one(self):
        arch = _moe_arch()
        p = _moe_params(arch)
        p["router"] = torch.zeros_like(p["router"])
        x = torch.randn((2, 64, 32), generator=torch.Generator().manual_seed(1))
        _, aux = PM.moe_ffn(x, p, arch, ShardingCtx())
        assert abs(float(aux) - 1.0) < 1e-6
        assert abs(_ref_moe(x, p, arch)[1] - 1.0) < 1e-6

    def test_grouped_dispatch_is_per_group(self):
        """dp_size > 1 (a mesh given by its shape): each data-parallel group
        dispatches its own tokens under its own capacity, so the grouped
        call equals the groups run one by one."""
        from repro_torch.parallel.sharding import MeshShape
        arch = _moe_arch(cf=0.8)
        p = _moe_params(arch)
        x = torch.randn((4, 8, 32), generator=torch.Generator().manual_seed(2))
        ctx = ShardingCtx(mesh=MeshShape((2, 1), ("data", "model")))
        assert ctx.dp_size == 2
        y, _ = PM.moe_ffn(x, p, arch, ctx)
        parts = [PM.moe_ffn(x[i:i + 2], p, arch, ShardingCtx())[0]
                 for i in (0, 2)]
        np.testing.assert_allclose(to_np(y), to_np(torch.cat(parts)), **TOL)


def _qkv(seed, b, s, h, kvh, hd):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((b, s, h, hd), generator=g),
            torch.randn((b, s, kvh, hd), generator=g),
            torch.randn((b, s, kvh, hd), generator=g))


def _j(*xs):
    return [jnp.asarray(to_np(x)) for x in xs]


class TestAttentionPaths:
    def test_swa_blocked_equals_masked_prefill(self):
        q, k, v = _qkv(0, 2, 64, 4, 2, 16)
        ctx = ShardingCtx()
        blocked = PA.attention_swa_blocked(q, k, v, window=16, ctx=ctx)
        masked = PA.attention_prefill(q, k, v, causal=True, window=16,
                                      ctx=ctx)
        np.testing.assert_allclose(to_np(blocked), to_np(masked), **TOL)
        ref = jax.jit(lambda *a: RA.attention_swa_blocked(
            *a, window=16, ctx=RefCtx()))(*_j(q, k, v))
        np.testing.assert_allclose(to_np(blocked), np.asarray(ref), **TOL)

    def test_online_blocks_equal_single_block(self):
        q, k, v = _qkv(1, 2, 64, 4, 4, 16)
        ctx = ShardingCtx()
        one = PA.attention_prefill(q, k, v, causal=True, window=0, ctx=ctx,
                                   kv_block=64)
        many = PA.attention_prefill(q, k, v, causal=True, window=0, ctx=ctx,
                                    kv_block=16)
        np.testing.assert_allclose(to_np(one), to_np(many), **TOL)
        for blk in (16, 24):
            ref = jax.jit(lambda *a, _b=blk: RA.attention_prefill(
                *a, causal=True, window=8, ctx=RefCtx(), kv_block=_b))(
                    *_j(q, k, v))
            got = PA.attention_prefill(q, k, v, causal=True, window=8,
                                       ctx=ctx, kv_block=blk)
            np.testing.assert_allclose(to_np(got), np.asarray(ref), **TOL)

    def test_decode_equals_prefill_last_position(self):
        q, k, v = _qkv(2, 2, 32, 4, 2, 16)
        ctx = ShardingCtx()
        full = PA.attention_prefill(q, k, v, causal=True, window=0, ctx=ctx)
        dec = PA.attention_decode(q[:, -1:], k, v, 31, window=0, ctx=ctx)
        np.testing.assert_allclose(to_np(dec[:, 0]), to_np(full[:, -1]),
                                   **TOL)
        ref = jax.jit(lambda *a: RA.attention_decode(
            *a, 31, window=5, ctx=RefCtx()))(*_j(q[:, -1:], k, v))
        got = PA.attention_decode(q[:, -1:], k, v, 31, window=5, ctx=ctx)
        np.testing.assert_allclose(to_np(got), np.asarray(ref), **TOL)

    @pytest.mark.parametrize("window,kv_block", [(0, 64), (8, 16), (8, 24)])
    def test_prefill_at_a_query_offset(self, window, kv_block):
        """``attention_prefill(q_offset=)``: the last 24 of 64 queries
        against all 64 keys equal the reference's at the same offset and
        the rows of the whole prefill (the causal and window masks take
        the queries' global positions)."""
        q, k, v = _qkv(4, 2, 64, 4, 2, 16)
        ctx = ShardingCtx()
        got = PA.attention_prefill(q[:, 40:], k, v, causal=True,
                                   window=window, ctx=ctx, kv_block=kv_block,
                                   q_offset=40)
        ref = jax.jit(lambda *a: RA.attention_prefill(
            *a, causal=True, window=window, ctx=RefCtx(), kv_block=kv_block,
            q_offset=40))(*_j(q[:, 40:], k, v))
        np.testing.assert_allclose(to_np(got), np.asarray(ref), **TOL)
        whole = PA.attention_prefill(q, k, v, causal=True, window=window,
                                     ctx=ctx, kv_block=kv_block)
        np.testing.assert_allclose(to_np(got), to_np(whole[:, 40:]), **TOL)

    def test_swa_blocked_at_a_query_offset(self):
        """``attention_swa_blocked(q_offset=)`` (a rank's w-blocks of a
        split sequence, the block before them from the whole k/v): the
        rows of the whole banded attention, at offsets 0, one block and
        the last block."""
        q, k, v = _qkv(5, 2, 64, 4, 2, 16)
        ctx = ShardingCtx()
        whole = PA.attention_swa_blocked(q, k, v, window=8, ctx=ctx)
        for off, n in ((0, 16), (8, 24), (56, 8)):
            got = PA.attention_swa_blocked(q[:, off:off + n], k, v, window=8,
                                           ctx=ctx, q_offset=off)
            np.testing.assert_allclose(to_np(got),
                                       to_np(whole[:, off:off + n]), **TOL)

    def test_encoder_attention_is_bidirectional(self):
        q, k, v = _qkv(3, 1, 16, 2, 2, 8)
        ref = jax.jit(lambda *a: RA.attention_prefill(
            *a, causal=False, window=0, ctx=RefCtx()))(*_j(q, k, v))
        got = PA.attention_prefill(q, k, v, causal=False, window=0,
                                   ctx=ShardingCtx())
        np.testing.assert_allclose(to_np(got), np.asarray(ref), **TOL)


def _ref_rope(x, pos):
    """The reference's ``apply_rope`` run op by op: jitted, XLA's fused
    form of it differs from its own op-by-op result by up to 2e-4 at
    positions near 10,000 (sin / cos of angles in the thousands of
    radians), where op by op it equals the port's."""
    return RL.apply_rope(x, pos, 10000.0)


class TestRoPE:
    @settings(max_examples=20, deadline=None)
    @given(st.integers(0, 10000), st.integers(1, 8))
    def test_rotation_preserves_norm(self, pos, h):
        x = torch.randn((1, 4, h, 16), generator=torch.Generator()
                        .manual_seed(h))
        y = PL.apply_rope(x, torch.full((4,), pos), theta=10000.0)
        np.testing.assert_allclose(to_np(y.norm(dim=-1)),
                                   to_np(x.norm(dim=-1)), rtol=1e-4)
        ref = _ref_rope(jnp.asarray(to_np(x)), jnp.full((4,), pos))
        np.testing.assert_allclose(to_np(y), np.asarray(ref), **TOL)

    def test_relative_property(self):
        g = torch.Generator().manual_seed(0)
        q = torch.randn((1, 1, 1, 32), generator=g)
        k = torch.randn((1, 1, 1, 32), generator=g)

        def dot_at(m, n):
            qm = PL.apply_rope(q, torch.tensor([m]), 10000.0)
            kn = PL.apply_rope(k, torch.tensor([n]), 10000.0)
            return float((qm * kn).sum())
        assert abs(dot_at(5, 3) - dot_at(105, 103)) < 1e-3
        assert abs(dot_at(7, 7) - dot_at(0, 0)) < 1e-3


def test_layer_primitives_match_the_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    z = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_allclose(to_np(PL.rmsnorm(t(x), t(w))),
                               np.asarray(RL.rmsnorm(x, w)), **TOL)
    np.testing.assert_allclose(to_np(PL.rmsnorm_gated(t(x), t(z), t(w))),
                               np.asarray(RL.rmsnorm_gated(x, z, w)), **TOL)
    np.testing.assert_allclose(to_np(PL.rope_freqs(16, 1e6)),
                               np.asarray(RL.rope_freqs(16, 1e6)), **TOL)
    lg = rng.standard_normal((2, 1, 640)).astype(np.float32)
    np.testing.assert_array_equal(to_np(PL.mask_vocab_pad(t(lg), 503)),
                                  np.asarray(RL.mask_vocab_pad(lg, 503)))
    assert ParamDecl((3,), (None,)).dtype == torch.float32
