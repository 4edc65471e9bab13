"""The fixed-function R-STDP update in the port against the reference:
``kernels/ppu_update`` (plain version), ``VectorUnit.apply_rstdp`` and
``core/rules.py``.

Tolerances:
- 6-bit weight codes exact, except that a code may differ by one where
  the float weight before rounding lies within 1e-4 of a .5 boundary;
- eligibility exact against the jitted reference: the port multiplies by
  the float32 reciprocal of 255, as XLA does for the reference's jitted
  division by a constant (``kernels/ppu_update/ref.py``);
- mean rewards and float weights of the generic rules rtol = atol = 1e-4.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close, t
from repro.configs.bss2 import BSS2 as J_BSS2
from repro.core import rules as j_rules
from repro.core.anncore import AnnCore as JAnnCore
from repro.core.ppu import VectorUnit as JVectorUnit
from repro.kernels.ppu_update import ops as j_ppu_ops
from repro.verif.mismatch import sample_instance
from repro_torch import convert, kernels
from repro_torch.configs.bss2 import BSS2
from repro_torch.core import rules as t_rules
from repro_torch.core.ppu import VectorUnit
from repro_torch.kernels.ppu_update import ops as t_ppu_ops
from repro_torch.kernels.ppu_update.ref import rstdp_update_ref

CFG = dataclasses.replace(BSS2.reduced(), n_rows=16, n_cols=16)
CFG_J = dataclasses.replace(J_BSS2.reduced(), n_rows=16, n_cols=16)


def assert_codes_match(got, want, w_float, wmax=63):
    """int codes equal, except one off where ``w_float`` (the value before
    rounding) lies within 1e-4 of a .5 boundary inside [0, wmax]."""
    got = np.asarray(got, np.int32)
    want = np.asarray(want, np.int32)
    d = np.abs(got - want)
    assert d.max(initial=0) <= 1, "a code differs by more than one"
    x = np.clip(np.asarray(w_float, np.float64), -1.0, wmax + 1.0)
    tie = np.abs(x - np.floor(x) - 0.5) < 1e-4
    bad = (d == 1) & ~tie
    assert not bad.any(), (f"{int(bad.sum())} code(s) differ away from a "
                           ".5 boundary")


def _operands(prefix, R, C, seed, ties=False):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 64, (*prefix, R, C)).astype(np.int8)
    ac = rng.uniform(0, 40, (*prefix, R, C)).astype(np.float32)
    aa = rng.uniform(0, 40, (*prefix, R, C)).astype(np.float32)
    off = rng.uniform(-3, 12, (*prefix, C)).astype(np.float32)
    gain = rng.uniform(0.8, 1.2, (*prefix, C)).astype(np.float32)
    mod = rng.uniform(-1, 1, (*prefix, C)).astype(np.float32)
    xi = (0.3 * rng.standard_normal((*prefix, R, C))).astype(np.float32)
    if ties:
        # analog codes on exact .5 ties (gain 1/8, offset 0: code = a),
        # and accumulators that saturate the CADC range
        gain[..., :4] = 0.125
        off[..., :4] = 0.0
        ac[..., :4] = rng.integers(0, 60, ac[..., :4].shape) + 0.5
        ac[..., 4:6] = 1e4
        mod[..., :2] = 0.0
        xi[..., :2] = 0.5
    return w, ac, aa, off, gain, mod, xi


def _w_float(w, ac, aa, off, gain, mod, xi, eta):
    """The pre-rounding float weight, in float64, to locate ties."""
    def code(a):
        return np.clip(np.rint(a * (gain[..., None, :] * 8.0)
                               + off[..., None, :]), 0, 255)
    elig = (code(ac) - code(aa)) / 255.0
    return w + eta * mod[..., None, :] * elig + xi


class TestKernelPlain:
    @pytest.mark.parametrize("R,C", [(16, 16), (64, 128), (37, 45)])
    @pytest.mark.parametrize("ties", [False, True])
    def test_plain_matches_reference(self, R, C, ties):
        ops = _operands((), R, C, seed=R + C, ties=ties)
        eta = 2.5
        want_w, want_e = j_ppu_ops.rstdp_update(*ops, eta=eta, impl="ref")
        got_w, got_e = rstdp_update_ref(*(t(x) for x in ops), eta=eta)
        assert got_w.dtype == torch.int8 and got_e.dtype == torch.float32
        np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
        assert_codes_match(got_w.numpy(), want_w, _w_float(*ops, eta))

    def test_plain_matches_pallas_interpret(self):
        ops = _operands((), 64, 128, seed=5)
        want_w, want_e = j_ppu_ops.rstdp_update(*ops, eta=4.0,
                                                impl="interpret")
        got_w, got_e = rstdp_update_ref(*(t(x) for x in ops), eta=4.0)
        np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
        assert_codes_match(got_w.numpy(), want_w, _w_float(*ops, 4.0))

    def test_wrapper_dispatch_and_prefix(self):
        """CPU tensors run the plain version (no launch counted); an
        instance prefix matches the reference's vmap over instances."""
        prefix = (2, 3)
        ops = _operands(prefix, 16, 24, seed=6)
        n0 = kernels.LAUNCHES["ppu_update"]
        got_w, got_e = t_ppu_ops.rstdp_update(*(t(x) for x in ops), eta=1.5)
        assert kernels.LAUNCHES["ppu_update"] == n0
        fn = functools.partial(j_ppu_ops.rstdp_update, eta=1.5, impl="ref")
        want_w, want_e = jax.vmap(jax.vmap(fn))(*ops)
        np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
        assert_codes_match(got_w.numpy(), want_w, _w_float(*ops, 1.5))
        assert got_w.shape == (*prefix, 16, 24)

    def test_round_half_even(self):
        """rint, not round-half-away: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2."""
        w = torch.tensor([[0, 1, 2, 62]], dtype=torch.int8)
        z = torch.zeros((1, 4))
        xi = torch.tensor([[0.5, 0.5, 0.5, 0.5]])
        cols = torch.zeros(4)
        got, _ = rstdp_update_ref(w, z, z, cols, cols + 1, cols, xi, eta=1.0)
        assert got.tolist() == [[0, 2, 2, 62]]


def _state(prefix, seed):
    """A reference core state with spread weights and accumulators, and
    a binary reward."""
    inst = jax.tree.map(np.asarray, sample_instance(
        CFG_J, jax.random.PRNGKey(seed), prefix))
    st = JAnnCore(CFG_J, inst).init_state(prefix)
    rng = np.random.default_rng(seed)
    shape = (*prefix, CFG.n_rows, CFG.n_cols)
    st = st._replace(
        syn=st.syn._replace(weights=rng.integers(0, 64, shape
                                                 ).astype(np.int8)),
        corr=st.corr._replace(
            a_causal=(rng.random(shape) * 20).astype(np.float32),
            a_acausal=(rng.random(shape) * 20).astype(np.float32)),
        rate_counters=np.ones((*prefix, CFG.n_cols), np.float32))
    reward = (rng.random((*prefix, CFG.n_cols)) < 0.5).astype(np.float32)
    mean_r = rng.uniform(0, 1, (*prefix, CFG.n_cols)).astype(np.float32)
    return inst, jax.tree.map(np.asarray, st), reward, mean_r


class TestApplyRstdp:
    @pytest.mark.parametrize("prefix", [(), (2,)])
    def test_matches_reference(self, prefix):
        """The reference's jitted ``apply_rstdp(impl="ref")`` with its own
        key; the port with the same xi replayed through ``convert``."""
        inst, st, reward, mean_r = _state(prefix, seed=3)
        key = jax.random.PRNGKey(8)
        kw = dict(eta=4.0, gamma=0.3, noise=0.2)
        j_ppu = JVectorUnit(CFG_J, inst)
        fn = jax.jit(functools.partial(j_ppu.apply_rstdp, impl="ref", **kw))
        j_st, j_rs, j_elig = fn(st, dict(mean_reward=mean_r, key=key),
                                reward=reward)
        next_key, xi = convert.replay_rstdp_xi(
            jax.random, key, st.syn.weights.shape, kw["noise"], device="cpu")
        np.testing.assert_array_equal(np.asarray(next_key),
                                      np.asarray(j_rs["key"]))
        ppu = VectorUnit(CFG, convert.instance(inst, "cpu"))
        t_st, t_rs, t_elig = ppu.apply_rstdp(
            convert.core_state(st, "cpu"), dict(mean_reward=t(mean_r)),
            reward=t(reward), xi=xi, **kw)
        np.testing.assert_array_equal(t_elig.numpy(), np.asarray(j_elig))
        close(t_rs["mean_reward"], j_rs["mean_reward"])
        mod = reward - mean_r
        w_f = (st.syn.weights + kw["eta"] * mod[..., None, :]
               * np.asarray(j_elig) + xi.numpy())
        assert_codes_match(t_st.syn.weights.numpy(), j_st.syn.weights, w_f)
        assert not t_st.rate_counters.any()
        assert not t_st.corr.a_causal.any() and not t_st.corr.a_acausal.any()
        close(t_st.corr.trace_pre, j_st.corr.trace_pre)

    @pytest.mark.parametrize("prefix", [(), (2,)])
    def test_matches_generic_apply_rule(self, prefix):
        """Within the port: the fixed-function path against
        ``apply_rule(rules.rstdp)`` on the same xi (tests/test_fused.py::
        TestApplyRstdpKernelRouting). The generic rule divides by 255
        truly, so a store may differ by one at a .5 tie only."""
        inst, st, reward, _ = _state(prefix, seed=5)
        ppu = VectorUnit(CFG, convert.instance(inst, "cpu"))
        st_t = convert.core_state(st, "cpu")
        rs = dict(mean_reward=torch.zeros((*prefix, CFG.n_cols)))
        gen = torch.Generator().manual_seed(8)
        xi = t_rules.draw_xi(st_t.syn.weights.shape, 0.2, gen, "cpu")
        sg, rg, obs = ppu.apply_rule(t_rules.rstdp, st_t, dict(rs),
                                     reward=t(reward), eta=4.0, noise=0.2,
                                     xi=xi)
        sf, rf, elig = ppu.apply_rstdp(st_t, dict(rs), reward=t(reward),
                                       eta=4.0, noise=0.2, xi=xi)
        dw = (sg.syn.weights.to(torch.int32)
              - sf.syn.weights.to(torch.int32)).abs()
        assert int(dw.max()) <= 1 and float((dw > 0).float().mean()) < 0.01
        close(rg["mean_reward"], rf["mean_reward"])
        assert float(sf.rate_counters.sum()) == 0.0
        assert float(sf.corr.a_causal.sum()) == 0.0
        ref_elig = (obs["causal"] - obs["acausal"]).numpy() / 255.0
        close(elig, ref_elig)
        np.testing.assert_array_equal(
            np.rint(elig.numpy() * 255),
            (obs["causal"] - obs["acausal"]).numpy())

    def test_generator_draw(self):
        """Without an injected plane the walk comes from the generator:
        the same seed gives the same update, and no xi at all raises."""
        inst, st, reward, mean_r = _state((), seed=4)
        ppu = VectorUnit(CFG, convert.instance(inst, "cpu"))
        st_t = convert.core_state(st, "cpu")
        outs = [ppu.apply_rstdp(st_t, dict(mean_reward=t(mean_r)),
                                reward=t(reward),
                                generator=torch.Generator().manual_seed(1))
                for _ in range(2)]
        assert torch.equal(outs[0][0].syn.weights, outs[1][0].syn.weights)
        with pytest.raises(ValueError, match="xi"):
            ppu.apply_rstdp(st_t, dict(mean_reward=t(mean_r)),
                            reward=t(reward))


class TestRules:
    def _obs(self, prefix, seed):
        rng = np.random.default_rng(seed)
        shape = (*prefix, 16, 24)
        w = rng.uniform(0, 63, shape).astype(np.float32)
        obs = dict(causal=rng.integers(0, 256, shape).astype(np.int32),
                   acausal=rng.integers(0, 256, shape).astype(np.int32),
                   rates=rng.integers(0, 9, (*prefix, 24)).astype(
                       np.float32))
        reward = (rng.random((*prefix, 24)) < 0.5).astype(np.float32)
        mean_r = rng.uniform(0, 1, (*prefix, 24)).astype(np.float32)
        return w, obs, reward, mean_r

    @pytest.mark.parametrize("prefix", [(), (3,)])
    def test_rstdp(self, prefix):
        w, obs, reward, mean_r = self._obs(prefix, seed=1)
        key = jax.random.PRNGKey(2)
        j_w, j_rs = j_rules.rstdp(jnp.asarray(w), obs, dict(
            mean_reward=mean_r, key=key), reward=reward, eta=3.0, noise=0.4)
        next_key, xi = convert.replay_rstdp_xi(jax.random, key, w.shape, 0.4,
                                               device="cpu")
        np.testing.assert_array_equal(np.asarray(next_key),
                                      np.asarray(j_rs["key"]))
        t_w, t_rs = t_rules.rstdp(
            t(w), {k: t(v) for k, v in obs.items()},
            dict(mean_reward=t(mean_r)), reward=t(reward), eta=3.0,
            noise=0.4, xi=xi)
        close(t_w, j_w)
        close(t_rs["mean_reward"], j_rs["mean_reward"])
        assert set(t_rs) == {"mean_reward"}

    def test_stdp_and_homeostasis(self):
        w, obs, _, _ = self._obs((2,), seed=3)
        tobs = {k: t(v) for k, v in obs.items()}
        rs = dict(mean_reward=np.zeros(24, np.float32))
        j_w, _ = j_rules.stdp(jnp.asarray(w), obs, rs, eta_plus=0.2,
                              eta_minus=0.15)
        t_w, t_rs = t_rules.stdp(t(w), tobs, rs, eta_plus=0.2,
                                 eta_minus=0.15)
        close(t_w, j_w)
        assert t_rs is rs
        j_w, _ = j_rules.homeostasis(jnp.asarray(w), obs, rs,
                                     target_rate=3.0, eta=0.3)
        t_w, _ = t_rules.homeostasis(t(w), tobs, rs, target_rate=3.0,
                                     eta=0.3)
        close(t_w, j_w)
