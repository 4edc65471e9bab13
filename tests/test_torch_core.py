"""Parity of the port's core functions (``repro_torch.core``) with the JAX
reference (``repro.core``), on the CPU at small sizes.

Every input is made with numpy from a seed and handed to both packages.
Tolerances:
- integer outputs (CADC codes, 6-bit stores, spikes, calibration codes):
  exact;
- floats: rtol = atol = 1e-4, the house tolerance (docs/exactness.md).
  The two frameworks' ``exp`` kernels and reduction orders differ, so
  floats agree to a few ulp, not bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import bss2 as j_bss2
from repro.core import adex as j_adex
from repro.core import cadc as j_cadc
from repro.core import capmem as j_capmem
from repro.core import correlation as j_corr
from repro.core import stp as j_stp
from repro.core import synapse as j_syn
from repro.verif import mismatch as j_mm
from repro_torch import convert
from repro_torch.configs import bss2 as t_bss2
from repro_torch.core import adex as t_adex
from repro_torch.core import cadc as t_cadc
from repro_torch.core import capmem as t_capmem
from repro_torch.core import correlation as t_corr
from repro_torch.core import stp as t_stp
from repro_torch.core import synapse as t_syn
from repro_torch.verif import mismatch as t_mm

TOL = dict(rtol=1e-4, atol=1e-4)
CFG_J = dataclasses.replace(j_bss2.BSS2.reduced(), n_rows=32, n_cols=16)
CFG_T = dataclasses.replace(t_bss2.BSS2.reduced(), n_rows=32, n_cols=16)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), **(kw or TOL))


def _params(prefix=(), seed=0):
    """Reference-sampled neuron parameters, as (jax dict, torch dict)."""
    inst = jax.tree.map(np.asarray, j_mm.sample_instance(
        CFG_J, jax.random.PRNGKey(seed), prefix))
    return inst["neuron_params"], convert.instance(inst, "cpu")[
        "neuron_params"]


class TestConfigs:
    def test_bss2_fields_equal(self):
        assert dataclasses.asdict(t_bss2.BSS2) == \
            dataclasses.asdict(j_bss2.BSS2)
        assert dataclasses.asdict(t_bss2.BSS2.reduced()) == \
            dataclasses.asdict(j_bss2.BSS2.reduced())

    def test_capmem_nominal(self):
        got = t_capmem.nominal(CFG_T, device="cpu")
        want = j_capmem.nominal(CFG_J)
        assert t_capmem.NEURON_PARAMS == j_capmem.NEURON_PARAMS
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))

    @pytest.mark.parametrize("prefix", [(), (2,)])
    def test_ideal_instance(self, prefix):
        got = convert.to_numpy(t_mm.ideal_instance(CFG_T, prefix, "cpu"))
        want = jax.tree.map(np.asarray, j_mm.ideal_instance(CFG_J, prefix))
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(np.broadcast_to(a, b.shape), b)

    def test_sample_instance_shapes_and_spread(self):
        """The port's generator cannot reproduce threefry draws; it must
        give the reference's shapes, dtypes and spreads, and be a pure
        function of the generator's seed."""
        prefix = (64,)
        got = t_mm.sample_instance(CFG_T, torch.Generator().manual_seed(3),
                                   prefix, device="cpu")
        again = t_mm.sample_instance(CFG_T, torch.Generator().manual_seed(3),
                                     prefix, device="cpu")
        want = jax.tree.map(np.asarray, j_mm.sample_instance(
            CFG_J, jax.random.PRNGKey(3), prefix))
        g, w = convert.to_numpy(got), want
        assert jax.tree.structure(g) == jax.tree.structure(w)
        for a, b, c in zip(jax.tree.leaves(g), jax.tree.leaves(w),
                           jax.tree.leaves(convert.to_numpy(again))):
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_array_equal(a, c)
        mm = CFG_T.mismatch
        assert abs(g["weight_gain"].std() - mm.sigma_weight_gain) < 0.03
        assert abs(g["stp_offset"].std() - mm.sigma_stp_offset) < 0.03
        assert abs(g["neuron_params"]["v_thres"].std()
                   - mm.sigma_v_thres) < 0.2

    def test_entry_points_raise_without_device(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_capmem.nominal(CFG_T)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_mm.ideal_instance(CFG_T)


class TestSTP:
    def test_efficacy_and_update_match(self):
        rng = np.random.default_rng(0)
        R = 32
        r = rng.uniform(0, 1, (3, R)).astype(np.float32)
        spk = (rng.random((3, R)) < 0.4).astype(np.float32)
        off = (0.25 * rng.standard_normal((3, R))).astype(np.float32)
        calib = rng.integers(0, 16, (3, R)).astype(np.int32)
        j_st, t_st = j_stp.STPState(jnp.asarray(r)), t_stp.STPState(_t(r))
        want = j_stp.efficacy(j_st, spk, u=0.2, offset=off, calib_code=calib)
        got = t_stp.efficacy(t_st, _t(spk), u=0.2, offset=_t(off),
                             calib_code=_t(calib))
        _close(got, want)
        scale = t_stp.efficacy_scale(_t(off), _t(calib))
        np.testing.assert_array_equal(
            t_stp.efficacy(t_st, _t(spk), u=0.2, scale=scale).numpy(),
            got.numpy())
        want_u = j_stp.update(j_st, spk, u=0.2, tau_rec=20.0, dt=0.2)
        got_u = t_stp.update(t_st, _t(spk), u=0.2, tau_rec=20.0, dt=0.2)
        _close(got_u.r, want_u.r)
        assert t_stp.recovery_factor(20.0, 0.2) == float(
            j_stp.recovery_factor(20.0, 0.2))


class TestAdEx:
    @pytest.mark.parametrize("use_adex", [True, False])
    def test_step_matches(self, use_adex):
        rng = np.random.default_rng(1)
        jp, tp = _params((4,), seed=1)
        shape = (4, CFG_T.n_cols)
        v = rng.uniform(-72, -44, shape).astype(np.float32)
        w = rng.uniform(0, 40, shape).astype(np.float32)
        ie = rng.uniform(0, 200, shape).astype(np.float32)
        ii = rng.uniform(0, 100, shape).astype(np.float32)
        ref = rng.choice([0.0, 0.0, 0.3], shape).astype(np.float32)
        cur = rng.uniform(0, 300, (2, *shape)).astype(np.float32)
        j_st = j_adex.NeuronState(*map(jnp.asarray, (v, w, ie, ii, ref)))
        t_st = t_adex.NeuronState(*map(_t, (v, w, ie, ii, ref)))
        j_new, j_spk = j_adex.step(j_st, cur[0], cur[1], jp, 0.2,
                                   adex=use_adex)
        t_new, t_spk = t_adex.step(t_st, _t(cur[0]), _t(cur[1]), tp, 0.2,
                                   adex=use_adex)
        assert float(np.asarray(j_spk).sum()) > 0
        np.testing.assert_array_equal(t_spk.numpy(), np.asarray(j_spk))
        for a, b in zip(t_new, j_new):
            _close(a, b)

    def test_decay_factors(self):
        jp, tp = _params((2,), seed=2)
        want = j_adex.decay_factors(jp, 0.2)
        got = t_adex.decay_factors(tp, 0.2)
        for k in want:
            _close(got[k], want[k], rtol=1e-6, atol=0)


class TestCADC:
    def test_digitize_exact(self):
        rng = np.random.default_rng(2)
        x = rng.uniform(0, 40, (3, 32, 16)).astype(np.float32)
        off = (4 * rng.standard_normal((3, 1, 16))).astype(np.float32)
        gain = (1 + 0.05 * rng.standard_normal((3, 1, 16))).astype(np.float32)
        want = j_cadc.digitize(x, offset=off, gain=gain, in_scale=8.0)
        got = t_cadc.digitize(_t(x), offset=_t(off), gain=_t(gain),
                              in_scale=8.0)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_round_half_even(self):
        x = np.asarray([0.5, 1.5, 2.5, -0.5, 300.0], np.float32)
        z = np.zeros_like(x)
        got = t_cadc.digitize(_t(x), offset=_t(z), gain=_t(z + 1))
        want = j_cadc.digitize(x, offset=z, gain=z + 1)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


class TestSynapse:
    def _operands(self, prefix, T=13, R=16, C=16, seed=3, const=False):
        rng = np.random.default_rng(seed)
        w = rng.integers(0, 64, (*prefix, R, C)).astype(np.int8)
        a = rng.integers(0, 4, (*prefix, R, C)).astype(np.int8)
        ev = ((rng.random((T, *prefix, R)) < 0.3)
              * rng.uniform(0.2, 1.2, (T, *prefix, R))).astype(np.float32)
        if const:
            ea = np.broadcast_to(rng.integers(0, 4, (*prefix, R)),
                                 (T, *prefix, R)).astype(np.int8)
        else:
            ea = rng.integers(0, 4, (T, *prefix, R)).astype(np.int8)
        gain = (1 + 0.2 * rng.standard_normal((*prefix, C))).astype(
            np.float32)
        return w, a, ev, ea, gain

    def test_synaptic_current_step(self):
        w, a, ev, ea, gain = self._operands((2,))
        want = j_syn.synaptic_current(w, a, ev[0], ea[0], gain)
        got = t_syn.synaptic_current(_t(w), _t(a), _t(ev[0]), _t(ea[0]),
                                     _t(gain))
        _close(got, want)

    @pytest.mark.parametrize("prefix", [(), (2,)])
    @pytest.mark.parametrize("const_addr", [False, True])
    def test_window_matches(self, prefix, const_addr):
        w, a, ev, ea, gain = self._operands(prefix, const=const_addr)
        want = j_syn.synaptic_current_window(
            w, a, ev, ea, gain, const_addr=const_addr, sparse="never")
        for sparse in ("never", "auto"):
            got = t_syn.synaptic_current_window(
                _t(w), _t(a), _t(ev), _t(ea), _t(gain),
                const_addr=const_addr, sparse=sparse)
            _close(got, want)

    def test_sparse_route_not_ported(self):
        """Above the static floor "auto" reaches the census gate and takes
        the event-sparse route (ported now, tests/test_torch_sparse.py)
        instead of raising; "always" runs it below the floor too. All
        three modes give the dense currents on windows that fit."""
        T, R, C = 128, 128, 256               # T*R*C = 4M > 2M floor
        rng = np.random.default_rng(5)
        w = _t(rng.integers(0, 64, (R, C)).astype(np.int8))
        ev = _t(((rng.random((T, R)) < 0.01)
                 * rng.uniform(0.2, 1.2, (T, R))).astype(np.float32))
        ea = torch.zeros((T, R), dtype=torch.int8)
        assert t_syn.window_route(ev, C)[0] == "sparse"
        dense = t_syn.synaptic_current_window(w, w, ev, ea, 1.0,
                                              sparse="never")
        assert dense.shape == (T, C)
        for mode in ("auto", "always"):
            _close(t_syn.synaptic_current_window(w, w, ev, ea, 1.0,
                                                 sparse=mode), dense)
        small = t_syn.synaptic_current_window(w[:4], w[:4], ev[:, :4],
                                              ea[:, :4], 1.0, sparse="always")
        _close(small, t_syn.synaptic_current_window(
            w[:4], w[:4], ev[:, :4], ea[:, :4], 1.0, sparse="never"))
        with pytest.raises(ValueError, match="unknown sparse mode"):
            t_syn.synaptic_current_window(w, w, ev, ea, 1.0, sparse="on")

    def test_quantize_weight_exact(self):
        x = np.asarray([-3.2, 0.5, 1.5, 2.5, 31.49, 62.5, 63.5, 80.0],
                       np.float32)
        got = t_syn.quantize_weight(_t(x))
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(j_syn.quantize_weight(x)))


class TestCorrelation:
    def _window(self, prefix, T=40, R=16, C=16, seed=4):
        rng = np.random.default_rng(seed)
        pre = (rng.random((T, *prefix, R)) < 0.2).astype(np.float32)
        post = (rng.random((T, *prefix, C)) < 0.2).astype(np.float32)
        st = [rng.random((*prefix, R)).astype(np.float32),
              rng.random((*prefix, C)).astype(np.float32),
              rng.uniform(0, 1023, (*prefix, R, C)).astype(np.float32),
              rng.uniform(0, 5, (*prefix, R, C)).astype(np.float32)]
        return pre, post, st

    def test_update_matches(self):
        pre, post, st = self._window((2,))
        j_st = j_corr.CorrelationState(*map(jnp.asarray, st))
        t_st = t_corr.CorrelationState(*map(_t, st))
        for t in range(5):
            j_st = j_corr.update(j_st, pre[t], post[t], tau_pre=5.0,
                                 tau_post=5.0, dt=0.2)
            t_st = t_corr.update(t_st, _t(pre[t]), _t(post[t]), tau_pre=5.0,
                                 tau_post=5.0, dt=0.2)
        for a, b in zip(t_st, j_st):
            _close(a, b)

    @pytest.mark.parametrize("prefix", [(), (2,)])
    @pytest.mark.parametrize("taus", [(5.0, 5.0), (5.0, 8.0)])
    def test_window_matches(self, prefix, taus):
        """Kernel parameters go through the corr wrapper (per-step plain
        version on the CPU), others through the contracted CPU form; the
        reference's CPU path is the contracted form for both."""
        pre, post, st = self._window(prefix)
        kw = dict(tau_pre=taus[0], tau_post=taus[1], dt=0.2)
        want = j_corr.window(j_corr.CorrelationState(*map(jnp.asarray, st)),
                             pre, post, impl="ref", **kw)
        got = t_corr.window(t_corr.CorrelationState(*map(_t, st)), _t(pre),
                            _t(post), **kw)
        assert float(np.asarray(want.a_causal).max()) == 1023.0
        for a, b in zip(got, want):
            _close(a, b)

    def test_negative_eta_per_step(self):
        pre, post, st = self._window((), T=12)
        kw = dict(tau_pre=5.0, tau_post=5.0, dt=0.2, eta=-0.5)
        want = j_corr.window(j_corr.CorrelationState(*map(jnp.asarray, st)),
                             pre, post, impl="ref", **kw)
        got = t_corr.window(t_corr.CorrelationState(*map(_t, st)), _t(pre),
                            _t(post), **kw)
        for a, b in zip(got, want):
            _close(a, b)
