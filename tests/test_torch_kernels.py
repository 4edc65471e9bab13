"""The port's kernels: each plain version against the JAX kernel (Pallas in
interpret mode, as tests/test_kernels.py runs it) and against the JAX
reference; and each wrapper's dispatch by device. The CUDA kernels against
their plain versions are in tests/test_torch_cuda.py.

Tolerances (see tests/_torch_parity.py): floats rtol = atol = 1e-4;
spikes equal up to flips at threshold.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (CORR_EDGE_CASES, assert_spikes_match, close,
                           corr_edge_operands, spike_threshold, t)
from repro.configs.bss2 import BSS2 as J_BSS2
from repro.core import adex as j_adex
from repro.core import synapse as j_synapse
from repro.kernels.corr.kernel import correlation_window_pallas
from repro.kernels.corr.ref import correlation_window_ref as j_corr_ref
from repro.kernels.neuron_scan import ops as j_neuron_ops
from repro.kernels.synray.kernel import synaptic_current_pallas
from repro.kernels.synray.ref import synaptic_current_ref as j_syn_ref
from repro.verif.mismatch import sample_instance
from repro_torch import kernels
from repro_torch.core import adex, synapse
from repro_torch.kernels.corr import ops as corr_ops
from repro_torch.kernels.corr.ref import correlation_window_ref
from repro_torch.kernels.neuron_scan import ops as neuron_ops
from repro_torch.kernels.neuron_scan.ref import neuron_window_ref
from repro_torch.kernels.synray import ops as synray_ops
from repro_torch.kernels.synray.ref import synaptic_current_ref


# --------------------------------------------------------------- synray

def _synray_operands(T, N, R, C, seed, const=False):
    rng = np.random.default_rng(seed)
    ev = ((rng.random((T, N, R)) < 0.2)
          * rng.uniform(0.2, 1.2, (T, N, R))).astype(np.float32)
    if const:
        ea = np.broadcast_to(rng.integers(0, 4, (N, R)), (T, N, R))
    else:
        ea = rng.integers(0, 4, (T, N, R))
    ea = np.ascontiguousarray(ea).astype(np.int8)
    w = rng.integers(0, 64, (N, R, C)).astype(np.int8)
    a = rng.integers(0, 4, (N, R, C)).astype(np.int8)
    return ev, ea, w, a


class TestSynray:
    @pytest.mark.parametrize("T,N,R,C", [(13, 2, 32, 128), (8, 1, 64, 128),
                                         (16, 3, 16, 16)])
    def test_plain_matches_pallas_interpret_and_ref(self, T, N, R, C):
        ev, ea, w, a = _synray_operands(T, N, R, C, seed=T + R)
        got = synaptic_current_ref(t(ev), t(ea), t(w), t(a)).numpy()
        # the Pallas kernel takes [N, B, R]: time is its batch axis
        pal = synaptic_current_pallas(
            jnp.moveaxis(ev, 0, 1), jnp.moveaxis(ea, 0, 1), w, a,
            bb=1 if T % 8 else 8, rb=min(64, R), cb=min(128, C),
            interpret=True)
        close(got, np.moveaxis(np.asarray(pal), 1, 0))
        for n in range(N):
            close(got[:, n], j_syn_ref(ev[:, n], ea[:, n], w[n], a[n]))

    def test_dale_half_views(self):
        """The Dale halves are strided row views of the store, read in
        place; the result equals that of a contiguous copy."""
        ev, ea, w, a = _synray_operands(13, 2, 32, 16, seed=5)
        tw, ta, tev, tea = t(w), t(a), t(ev), t(ea)
        for h in (0, 1):
            got = synray_ops.synaptic_current(
                tev[..., h::2], tea[..., h::2], tw[:, h::2], ta[:, h::2])
            want = j_syn_ref(ev[:, 0, h::2], ea[:, 0, h::2], w[0, h::2],
                             a[0, h::2])
            close(got[:, 0].numpy(), want)

    def test_wrapper_dispatch(self):
        ev, ea, w, a = _synray_operands(4, 2, 16, 16, seed=6)
        before = dict(kernels.LAUNCHES)
        got = synray_ops.synaptic_current(t(ev), t(ea), t(w), t(a))
        assert kernels.LAUNCHES == before, "the CPU path launches nothing"
        np.testing.assert_array_equal(
            got.numpy(),
            synaptic_current_ref(t(ev), t(ea), t(w), t(a)).numpy())
        meta = [x.to("meta") for x in (t(ev), t(ea), t(w), t(a))]
        with pytest.raises(ValueError, match="unsupported device"):
            synray_ops.synaptic_current(*meta)


    @pytest.mark.parametrize("T,N,R,C", [(13, 2, 32, 128), (37, 3, 45, 300),
                                         (8, 1, 16, 16)])
    def test_const_addr_keyword_on_cpu(self, T, N, R, C):
        """``const_addr=True`` on CPU tensors: the plain version, equal to
        the reference's plain version and to its const-address dense
        window (the mask resolved once from step 0) within 1e-4."""
        ev, ea, w, a = _synray_operands(T, N, R, C, seed=T + C, const=True)
        ops = (t(ev), t(ea), t(w), t(a))
        before = dict(kernels.LAUNCHES)
        got = synray_ops.synaptic_current(*ops, const_addr=True)
        assert kernels.LAUNCHES == before, "the CPU path launches nothing"
        assert torch.equal(got, synray_ops.synaptic_current(*ops))
        for n in range(N):
            close(got[:, n].numpy(), j_syn_ref(ev[:, n], ea[:, n], w[n], a[n]))
        want = j_synapse._dense_window(w, a, ev, ea, 1.0, "ref", True, None)
        close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("const_addr", [True, False])
def test_dense_window_passes_const_addr(monkeypatch, const_addr):
    """Off the CPU the dense window hands its ``const_addr`` to the synray
    wrapper, whose const-address form the main path runs on the card."""
    seen = []

    def spy(ev, ea, w, a, *, const_addr=False):
        seen.append(const_addr)
        return torch.zeros((ev.shape[0], *w.shape[:-2], w.shape[-1]),
                           device=ev.device)
    monkeypatch.setattr(synray_ops, "synaptic_current", spy)
    ev, ea, w, a = (t(x).to("meta")
                    for x in _synray_operands(4, 2, 16, 16, seed=8))
    out = synapse.synaptic_current_window(w, a, ev, ea, 1.0,
                                          const_addr=const_addr,
                                          sparse="never")
    assert seen == [const_addr]
    assert out.shape == (4, 2, 16)


def test_fold_helpers_match_reference():
    from repro.kernels import fold_instance_time as j_fold_t
    from repro_torch.kernels import (fold_instance, fold_instance_time,
                                     unfold_instance, unfold_instance_time)
    x = np.arange(5 * 2 * 3 * 4, dtype=np.float32).reshape(5, 2, 3, 4)
    y = fold_instance_time(t(x), 1)                  # [T, 2, 3, C]
    np.testing.assert_array_equal(y.numpy(), np.asarray(j_fold_t(x, 1)))
    assert torch.equal(unfold_instance_time(y, (2, 3)), t(x))
    z = fold_instance(t(x), 2)
    assert z.shape == (10, 3, 4)
    assert torch.equal(unfold_instance(z, (5, 2)), t(x))


# ---------------------------------------------------------- neuron_scan

def _neuron_operands(T, prefix, seed):
    cfg = J_BSS2.reduced()
    inst = jax.tree.map(np.asarray, sample_instance(
        cfg, jax.random.PRNGKey(seed), prefix))
    jp = inst["neuron_params"]
    rng = np.random.default_rng(seed)
    shape = (T, *prefix, cfg.n_cols)
    ie = ((rng.random(shape) < 0.15)
          * rng.uniform(0, 600, shape)).astype(np.float32)
    ii = ((rng.random(shape) < 0.05)
          * rng.uniform(0, 100, shape)).astype(np.float32)
    v0 = rng.uniform(-60, -47, shape[1:]).astype(np.float32)
    return cfg, jp, ie, ii, v0


def _states(v0):
    """The same initial neuron state in both packages (membranes spread
    up to threshold so short windows spike too)."""
    z = np.zeros_like(v0)
    return (j_adex.NeuronState(*map(jnp.asarray, (v0, z, z, z, z))),
            adex.NeuronState(*map(t, (v0, z, z, z, z))))


class TestNeuronScan:
    @pytest.mark.parametrize("T,prefix", [(13, (2,)), (64, ()),
                                          (40, (2,))])
    @pytest.mark.parametrize("impl", ["interpret", "ref"])
    def test_plain_matches_reference(self, T, prefix, impl):
        cfg, jp, ie, ii, v0 = _neuron_operands(T, prefix, seed=T)
        tp = {k: t(v) for k, v in jp.items()}
        j_st, t_st = _states(v0)
        rc = np.zeros((*prefix, cfg.n_cols), np.float32)
        j_new, j_rc, j_recs = j_neuron_ops.neuron_window(
            j_st, rc, ie, ii, jp, dt=cfg.dt, use_adex=True, impl=impl,
            kernel_block=8, record_v=True)
        t_new, t_rc, t_recs = neuron_window_ref(
            t_st, t(rc), t(ie), t(ii),
            tp, dt=cfg.dt, use_adex=True,
            decays=adex.decay_factors(tp, cfg.dt), record_v=True)
        assert float(np.asarray(j_recs[0]).sum()) > 0
        assert_spikes_match(t_recs[0], j_recs[0], t_recs[1], j_recs[1],
                            spike_threshold(jp))
        np.testing.assert_array_equal(t_rc.numpy(), np.asarray(j_rc))
        close(t_recs[1], j_recs[1])
        for a, b in zip(t_new, j_new):
            close(a, b)

    def test_wrapper_equals_adex_step_scan(self):
        """The plain version is bit-identical to stepping ``adex.step``."""
        cfg, jp, ie, ii, v0 = _neuron_operands(21, (2,), seed=3)
        tp = {k: t(v) for k, v in jp.items()}
        st0 = _states(v0)[1]
        rc0 = torch.zeros((2, cfg.n_cols))
        new, rc, recs = neuron_ops.neuron_window(st0, rc0, t(ie), t(ii), tp,
                                                 dt=cfg.dt, use_adex=True)
        st, acc, spk = st0, rc0, []
        for k in range(21):
            st, out = adex.step(st, t(ie[k]), t(ii[k]), tp, cfg.dt)
            acc = acc + out
            spk.append(out)
        assert torch.equal(recs[0], torch.stack(spk))
        assert torch.equal(rc, acc)
        for a, b in zip(new, st):
            assert torch.equal(a, b)


    @pytest.mark.parametrize("use_adex", [True, False])
    @pytest.mark.parametrize("T", [1, 7, 45])
    def test_chained_windows_match_reference(self, T, use_adex):
        """The inputs of the card's ragged-window cases
        (``test_torch_cuda.py::test_neuron_scan_ragged_chained``) on the
        CPU: window lengths that are no multiple of the kernel's chunk, two
        windows chained through the returned state, the v record on."""
        cfg, jp, ie, ii, v0 = _neuron_operands(2 * T, (3,), seed=T)
        tp = {k: t(v) for k, v in jp.items()}
        j_st, t_st = _states(v0)
        j_rc = rc = np.zeros((3, cfg.n_cols), np.float32)
        t_rc = t(rc)
        kw = dict(dt=cfg.dt, use_adex=use_adex, record_v=True)
        for w in (slice(0, T), slice(T, 2 * T)):
            j_st, j_rc, j_recs = j_neuron_ops.neuron_window(
                j_st, j_rc, ie[w], ii[w], jp, impl="ref", **kw)
            t_st, t_rc, t_recs = neuron_ops.neuron_window(
                t_st, t_rc, t(ie[w]), t(ii[w]), tp, **kw)
            assert_spikes_match(t_recs[0], j_recs[0], t_recs[1], j_recs[1],
                                spike_threshold(jp))
            np.testing.assert_array_equal(t_rc.numpy(), np.asarray(j_rc))
            close(t_recs[1], j_recs[1])
            for a, b in zip(t_st, j_st):
                close(a, b)


def test_launchers_match_argtypes():
    """Every ``extern "C"`` launcher in ``csrc/`` has a ctypes signature in
    ``_build.ARGTYPES`` with as many arguments, and every signature names a
    launcher: a mismatch would pass pointers as the wrong arguments on the
    card. ``ppuvm_exec``'s word limit is the same in the wrapper and the
    kernel."""
    import re

    from repro_torch.kernels import _build
    from repro_torch.kernels.ppuvm_exec import ops as vm_ops
    found = {}
    for path in sorted(_build.CSRC.glob("*.cu")):
        text = path.read_text()
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                       text):
            found[name] = len(params.split(","))
        if path.name == "ppuvm_exec.cu":
            limit = int(re.search(r"MAX_WORDS = (\d+);", text).group(1))
            assert limit == vm_ops.MAX_WORDS
    assert set(found) == set(_build.ARGTYPES)
    for name, n in found.items():
        assert n == len(_build.ARGTYPES[name]), name


def test_kernel_variants_name_real_constants():
    """``benchmarks/torch_kernel_variants.py`` changes only constants the
    kernel sources define (or makes an edit of its ``EDITS`` that the
    source has room for), and loads only launchers they export."""
    from benchmarks import torch_kernel_variants as tv
    from repro_torch.kernels import _build
    for name, variants in tv.VARIANTS.items():
        assert variants[0] == {}
        for consts in variants:
            text = tv.variant_source(name, consts)
            for const, value in consts.items():
                if const in tv.EDITS:
                    assert tv.EDITS[const][1](value) in text
                else:
                    assert f"constexpr int {const} = {value};" in text
        assert set(tv.LAUNCHERS[name]) <= set(_build.ARGTYPES)


# ----------------------------------------------------------------- corr

def _corr_operands(T, N, R, C, seed):
    rng = np.random.default_rng(seed)
    pre = (rng.random((T, N, R)) < 0.15).astype(np.float32)
    post = (rng.random((T, N, C)) < 0.15).astype(np.float32)
    tp0 = rng.random((N, R)).astype(np.float32)
    tq0 = rng.random((N, C)).astype(np.float32)
    ac0 = rng.uniform(0, 1023, (N, R, C)).astype(np.float32)
    aa0 = rng.uniform(0, 3, (N, R, C)).astype(np.float32)
    return pre, post, tp0, tq0, ac0, aa0


class TestCorr:
    LAM = math.exp(-0.2 / 5.0)

    @pytest.mark.parametrize("T,N,R,C", [(13, 2, 32, 128), (40, 1, 64, 128),
                                         (32, 2, 16, 16)])
    def test_plain_matches_pallas_interpret_and_ref(self, T, N, R, C):
        ops = _corr_operands(T, N, R, C, seed=T + C)
        got = correlation_window_ref(*map(t, ops), lam=self.LAM)
        pre, post, *st = ops
        pal = correlation_window_pallas(
            np.moveaxis(pre, 0, 1), np.moveaxis(post, 0, 1), *st,
            lam=self.LAM, rb=min(64, R), cb=min(128, C), interpret=True)
        assert float(np.asarray(pal[0]).max()) == 1023.0   # clamp active
        for g, p, name in zip(got, pal, ("ac", "aa", "tp", "tq")):
            close(g, p, err_msg=name)
        for n in range(N):
            ref = j_corr_ref(pre[:, n], post[:, n], *(x[n] for x in st),
                             lam=self.LAM)
            for g, r in zip(got, ref):
                close(g[n], r)

    @pytest.mark.parametrize("case", CORR_EDGE_CASES)
    def test_plain_edge_cases_match_reference(self, case):
        """The edge cases the card kernel is held to bit for bit
        (``tests/test_torch_cuda.py``): its plain version against the
        reference's, within 1e-4."""
        ops = corr_edge_operands(case)
        got = corr_ops.correlation_window(*map(t, ops), lam=self.LAM)
        pre, post, *st = ops
        for n in range(pre.shape[1]):
            ref = j_corr_ref(pre[:, n], post[:, n], *(x[n] for x in st),
                             lam=self.LAM)
            for g, r, name in zip(got, ref, ("ac", "aa", "tp", "tq")):
                close(g[n], r, err_msg=f"{case} {name}")

    def test_wrapper_dispatch(self):
        ops = [t(x) for x in _corr_operands(5, 1, 8, 8, seed=1)]
        before = dict(kernels.LAUNCHES)
        got = corr_ops.correlation_window(*ops, lam=self.LAM)
        assert kernels.LAUNCHES == before
        for a, b in zip(got, correlation_window_ref(*ops, lam=self.LAM)):
            assert torch.equal(a, b)
        with pytest.raises(ValueError, match="unsupported device"):
            corr_ops.correlation_window(*(x.to("meta") for x in ops),
                                        lam=self.LAM)

