"""AnnCore in the port: its three backends against each other (spikes bit
for bit, as tests/test_blocked.py holds the reference's), and
``AnnCore.run`` against the reference's ``AnnCore.run``.

Tolerances (see tests/_torch_parity.py): within the port spikes and rate
counters are exact, floats rtol = atol = 1e-4 (the correlation window sums
in another order than the per-step oracle); against the reference spikes
are equal up to flips at threshold and floats within 1e-4.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_parity import assert_spikes_match, close, spike_threshold, t
from repro.configs.bss2 import BSS2 as J_BSS2
from repro.core.anncore import AnnCore as JAnnCore
from repro.verif.mismatch import sample_instance
from repro_torch import convert
from repro_torch.configs.bss2 import BSS2
from repro_torch.core.anncore import AnnCore

CFG = dataclasses.replace(BSS2.reduced(), n_rows=16, n_cols=16)
CFG_J = dataclasses.replace(J_BSS2.reduced(), n_rows=16, n_cols=16)


def _setup(prefix, T, seed=0, p=0.15, n_addr=4, const=False):
    """Reference instance and state plus numpy events, for both packages."""
    inst = jax.tree.map(np.asarray, sample_instance(
        CFG_J, jax.random.PRNGKey(seed), prefix))
    jcore = JAnnCore(CFG_J, inst, backend="fused", const_addr=const)
    st = jcore.init_state(prefix)
    rng = np.random.default_rng(seed + 9)
    shape = (*prefix, CFG.n_rows, CFG.n_cols)
    st = st._replace(syn=st.syn._replace(
        weights=rng.integers(20, 64, shape).astype(np.int8),
        addresses=rng.integers(0, n_addr, shape).astype(np.int8)),
        # membranes spread up to threshold, so short windows spike too
        neuron=st.neuron._replace(v=rng.uniform(
            -58, -45, (*prefix, CFG.n_cols)).astype(np.float32)))
    ev = (rng.random((T, *prefix, CFG.n_rows)) < p).astype(np.float32)
    if const:
        ad = np.broadcast_to(rng.integers(0, n_addr, (*prefix, CFG.n_rows)),
                             ev.shape).astype(np.int8)
    else:
        ad = rng.integers(0, n_addr, ev.shape).astype(np.int8)
    return inst, jcore, st, ev, ad


def _port(inst, backend, const=False):
    return AnnCore(CFG, convert.instance(inst, "cpu"), backend=backend,
                   const_addr=const)


class TestBackends:
    @pytest.mark.parametrize("T,prefix", [(200, ()), (101, ()), (13, (2,)),
                                          (150, (3,))])
    def test_spikes_bit_identical(self, T, prefix):
        inst, _, st, ev, ad = _setup(prefix, T)
        st_t = convert.core_state(st, "cpu")
        outs = {}
        for b in ("oracle", "fused", "blocked"):
            outs[b] = _port(inst, b).run(st_t, t(ev), t(ad), record_v=True)
        s_o, o_o = outs["oracle"]
        assert float(o_o["spikes"].sum()) > 0, "drive must elicit spikes"
        for b in ("fused", "blocked"):
            s_b, o_b = outs[b]
            assert torch.equal(o_o["spikes"], o_b["spikes"]), b
            assert torch.equal(s_o.rate_counters, s_b.rate_counters), b
            close(o_o["v"], o_b["v"])
            for a, c in zip(jax.tree.leaves(convert.to_numpy(s_o)),
                            jax.tree.leaves(convert.to_numpy(s_b))):
                close(a, c)

    def test_auto_backend_on_cpu_is_fused(self):
        inst, *_ = _setup((), 4)
        assert _port(inst, "auto").backend == "fused"
        with pytest.raises(ValueError):
            _port(inst, "pallas")

    def test_const_addr_window(self):
        """const_addr resolves the mask once on the CPU; spikes stay equal
        to the oracle's."""
        inst, _, st, ev, ad = _setup((2,), 120, seed=2, const=True)
        st_t = convert.core_state(st, "cpu")
        _, o1 = _port(inst, "oracle").run(st_t, t(ev), t(ad))
        _, o2 = _port(inst, "blocked", const=True).run(st_t, t(ev), t(ad))
        assert torch.equal(o1["spikes"], o2["spikes"])


class TestAgainstReference:
    @pytest.mark.parametrize("backend", ["oracle", "fused", "blocked"])
    @pytest.mark.parametrize("prefix", [(), (2,)])
    def test_run_matches_reference(self, backend, prefix):
        inst, jcore, st, ev, ad = _setup(prefix, 120, seed=1)
        j_state, j_out = jcore.run(st, ev, ad, record_v=True)
        t_state, t_out = _port(inst, backend).run(
            convert.core_state(st, "cpu"), t(ev), t(ad), record_v=True)
        assert float(np.asarray(j_out["spikes"]).sum()) > 0
        assert_spikes_match(t_out["spikes"], j_out["spikes"], t_out["v"],
                            j_out["v"], spike_threshold(inst["neuron_params"]))
        close(t_out["v"], j_out["v"])
        np.testing.assert_array_equal(t_state.rate_counters.numpy(),
                                      np.asarray(j_state.rate_counters))
        for a, b in zip(jax.tree.leaves(convert.to_numpy(t_state)),
                        jax.tree.leaves(jax.tree.map(np.asarray, j_state))):
            close(a, b)
