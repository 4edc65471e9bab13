"""The port's three-factor readout trainer (``repro_torch.plasticity``)
against the reference's, on the CPU, with the reference's draws replayed
(``convert.replay_three_factor_draws``: its ``split(key, 3)`` chain, the
Gumbel draws of its ``categorical`` and its weight noise).

A sample may differ only where the reference's top-2 gap in
``logits / T + g`` is under 1e-5, and a code of ``w_q`` by one only where
the reference's ``w_new`` lies within 1e-4 of a .5 boundary (the einsum
sums in another order); both are counted. Then mirrors of
``tests/test_plasticity.py`` and of
``tests/test_system.py::test_hybrid_plasticity_on_lm_end_to_end``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import setup
from repro.data.pipeline import SyntheticLMPipeline as RefPipe
from repro.config import ShapeConfig as RefShape
from repro.models.transformer import prefix_len
from repro.plasticity import three_factor as RTF
from repro_torch import convert
from repro_torch.config import ShapeConfig, get_arch
from repro_torch.data.pipeline import SyntheticLMPipeline
from repro_torch.parallel.sharding import init_params
from repro_torch.plasticity.three_factor import (HybridReadoutTrainer,
                                                 PlasticState,
                                                 ThreeFactorConfig)

SHAPE = ShapeConfig("smoke", 32, 4, "train")
REF_SHAPE = RefShape("smoke", 32, 4, "train")


def _ref_w_new(rtr, params, st, batch, g, noise):
    """The reference's pre-rounding ``w_new`` and ``logits / T + g`` of a
    step, recomputed from its own functions with the replayed draws."""
    arch, pcfg = rtr.arch, rtr.pcfg
    feats = RTF._features_of(rtr.bundle, params, batch)[0]
    pl_ = prefix_len(arch)
    if pl_:
        feats = feats[:, pl_:]
    b, s, d = feats.shape
    phi = feats.reshape(b * s, d)
    logits = phi @ (st.w_q.astype(jnp.float32) * pcfg.w_scale)
    col = jnp.arange(logits.shape[-1])
    logits = jnp.where(col < arch.vocab, logits, -1e30)
    z = logits / pcfg.temperature
    p = jax.nn.softmax(z, axis=-1)
    samp = jnp.argmax(g + z, -1)
    r = (samp == batch["labels"].reshape(-1)).astype(jnp.float32)
    mean_r = st.mean_r + pcfg.gamma * (jnp.mean(r) - st.mean_r)
    post = jax.nn.one_hot(samp, logits.shape[-1]) - p
    dw = pcfg.eta * jnp.einsum("n,nd,nv->dv", r - mean_r, phi, post) \
        / phi.shape[0]
    if noise is not None:
        dw = dw + pcfg.noise * noise
    return (np.asarray(st.w_q.astype(jnp.float32) + dw / pcfg.w_scale),
            np.asarray(g + z))


@pytest.mark.parametrize("noise", [0.0, 0.01])
def test_step_matches_reference_with_replayed_draws(noise):
    """Six steps of the reduced smollm from the same state and batches:
    the reference's ``step`` with its own key, the port's with the draws
    replayed from that key. ``w_q`` codes, ``mean_r`` and the metrics."""
    ra, rb, rp, pa, pb, pp = setup("smollm-360m")
    pcfg = dict(eta=4.0, noise=noise)
    rtr = RTF.HybridReadoutTrainer(ra, pcfg=RTF.ThreeFactorConfig(**pcfg))
    ptr = HybridReadoutTrainer(pa, pcfg=ThreeFactorConfig(**pcfg),
                               device="cpu")
    key = jax.random.PRNGKey(1)
    rst = rtr.init_state(key)
    pst = ptr.init_state(torch.Generator().manual_seed(0))
    rpipe = RefPipe(ra, REF_SHAPE, seed=0)
    ppipe = SyntheticLMPipeline(pa, SHAPE, seed=0)
    n_tok = SHAPE.global_batch * SHAPE.seq_len
    sample_flips = code_flips = 0
    for i in range(6):
        rbatch = rpipe.next_batch()
        pbatch = ppipe.next_batch("cpu")
        key, g, nz = convert.replay_three_factor_draws(
            jax.random, rst.key, n_tok, pa.vocab_padded, pa.d_model, noise,
            "cpu")
        w_new, zg = _ref_w_new(rtr, rp, rst, rbatch,
                               jnp.asarray(g.numpy()),
                               None if nz is None else jnp.asarray(
                                   nz.numpy()))
        rst, rm = rtr.step(rp, rst, rbatch)
        assert np.array_equal(np.asarray(rst.key), np.asarray(key))
        pst, pm = ptr.step(pp, pst, pbatch, gumbel=g, noise=nz)
        # samples: the metrics and mean_r follow from them
        top2 = np.sort(zg, axis=-1)[:, -2:]
        near_tie = (top2[:, 1] - top2[:, 0]) < 1e-5
        sample_flips += int(near_tie.sum())
        if not near_tie.any():
            for k in ("reward", "mean_r", "acc_greedy"):
                np.testing.assert_allclose(float(pm[k]), float(rm[k]),
                                           rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(float(pst.mean_r), float(rst.mean_r),
                                       rtol=1e-6, atol=1e-7)
        diff = pst.w_q.numpy().astype(np.int32) - np.asarray(
            rst.w_q).astype(np.int32)
        assert (np.abs(diff) <= 1).all(), i
        frac = np.abs(w_new - np.floor(w_new) - 0.5)
        assert (frac[diff != 0] < 1e-4).all(), i
        code_flips += int((diff != 0).sum())
        # the states go on from the reference's, so flips do not compound
        pst = PlasticState(w_q=torch.tensor(np.asarray(rst.w_q)),
                           mean_r=torch.tensor(float(rst.mean_r)),
                           generator=pst.generator)
    assert pst.w_q.dtype == torch.int8
    assert int(np.abs(np.asarray(rst.w_q)).max()) > 0
    assert sample_flips == 0 and code_flips <= 4, (sample_flips, code_flips)


def test_host_loop_step_equals_step():
    _, _, _, pa, _, pp = setup("smollm-360m")
    tr = HybridReadoutTrainer(pa, pcfg=ThreeFactorConfig(noise=0.01),
                              device="cpu")
    pipe = SyntheticLMPipeline(pa, SHAPE, seed=0)
    a = tr.init_state(torch.Generator().manual_seed(3))
    b = tr.init_state(torch.Generator().manual_seed(3))
    for _ in range(3):
        batch = pipe.next_batch("cpu")
        a, ma = tr.step(pp, a, batch)
        b, mb = tr.host_loop_step(pp, b, batch)
        assert torch.equal(a.w_q, b.w_q)
        assert torch.equal(a.mean_r, b.mean_r)
        for k in ma:
            assert isinstance(mb[k], np.ndarray)
            assert float(ma[k]) == float(mb[k])
    assert int(a.w_q.abs().max()) > 0


# ---------------------------------------------------------------------------
# mirrors of tests/test_plasticity.py and
# tests/test_system.py::test_hybrid_plasticity_on_lm_end_to_end
# ---------------------------------------------------------------------------

def _trainer(name, **pcfg):
    arch = get_arch(name).reduced()
    tr = HybridReadoutTrainer(arch, pcfg=ThreeFactorConfig(**pcfg),
                              device="cpu")
    params = init_params(tr.bundle.decls, torch.Generator().manual_seed(0),
                         "cpu")
    st = tr.init_state(torch.Generator().manual_seed(1))
    return arch, tr, params, st


def test_three_factor_learns_markov_readout():
    arch, tr, params, st = _trainer("smollm-360m", eta=4.0)
    pipe = SyntheticLMPipeline(arch, SHAPE, seed=0)
    accs = []
    for _ in range(100):
        st, m = tr.step(params, st, pipe.next_batch("cpu"))
        accs.append(float(m["acc_greedy"]))
    # sampled-match rewards are sparse on a ~500-way task: the criterion
    # is a clear multiple of chance (1/vocab ~ 0.002)
    chance = 1.0 / arch.vocab
    assert np.mean(accs[-10:]) > 8 * chance, (chance, np.mean(accs[-10:]))
    assert np.mean(accs[-10:]) > np.mean(accs[:5]) + 0.01
    # weights stay within the signed 6-bit envelope (saturating writes)
    assert int(st.w_q.max()) <= 31 and int(st.w_q.min()) >= -31


def test_mean_reward_tracks():
    arch, tr, params, st = _trainer("qwen1.5-0.5b")
    pipe = SyntheticLMPipeline(arch, SHAPE, seed=3)
    for _ in range(5):
        st, m = tr.step(params, st, pipe.next_batch("cpu"))
    assert 0.0 <= float(st.mean_r) <= 1.0


@pytest.mark.parametrize("name", ["mamba2-130m", "hymba-1.5b",
                                  "moonshot-v1-16b-a3b"])
def test_applies_across_families(name):
    arch, tr, params, st = _trainer(name)
    pipe = SyntheticLMPipeline(arch, SHAPE, seed=0)
    st, m = tr.step(params, st, pipe.next_batch("cpu"))
    assert np.isfinite(float(m["reward"]))


def test_hybrid_plasticity_on_lm_end_to_end():
    arch, tr, params, st = _trainer("mamba2-130m")
    pipe = SyntheticLMPipeline(arch, ShapeConfig("s", 32, 4, "train"),
                               seed=0)
    rewards = []
    for _ in range(30):
        st, m = tr.step(params, st, pipe.next_batch("cpu"))
        rewards.append(float(m["reward"]))
    assert np.isfinite(rewards).all()
    assert int(st.w_q.abs().max()) <= 31  # 6-bit signed envelope
