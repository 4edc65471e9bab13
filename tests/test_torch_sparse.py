"""The port's event-sparse synaptic route against the reference's.

- ``kernels/synray_sparse``: the plain version against the reference's
  ``sparse_window_ref`` on the same regrouped records, and the whole
  pack-regroup-compute path against the reference's
  ``synaptic_current_sparse(impl="ref")``, drops included; the window
  form's plain version (``sparse_current_window``: ``regroup_window``
  then the plain version) on Dale halves read in place, through overflow
  of either capacity, -0.0 efficacies, an empty window and every row
  firing.
- ``synapse.synaptic_current_window`` with "never", "always" and "auto"
  above the static floor: the route (the census gate's decision, read
  from the reference's telemetry counters) must match exactly, the
  currents within tolerance; the gate's plain version (``kernels.census``:
  the census and its flag as an int32 tensor) equal to the reference's
  ``window_stats`` / ``census_fits``, its decisions counted in
  ``route_counts``; the device's composition (census, then both route
  kernels under its flag) run with the plain versions.
- ``AnnCore``: sparse against dense within the port; the windowed core's
  census gate, taken inside the STP scan (no census kernel), against the
  reference's core: currents, STP state, route counts and the telemetry
  gate counters, with both halves fitting, both overflowing and one of
  each.
- A teacher-forced §5 trial above the floor against the reference's
  ``make_experiment``, with the reference's instance and draws: same
  route for every window, same outputs.

Tolerances: routes, rate counters, CADC codes and 6-bit weights exact;
currents rtol = atol = 1e-4, the house tolerance (docs/exactness.md),
since PyTorch and XLA contract in other orders (and the const_addr dense
form is a once-resolved matmul); spikes equal up to flips at threshold.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_parity import assert_spikes_match, close, spike_threshold, t
from repro.configs.bss2 import BSS2 as J_BSS2
from repro.core import events as je
from repro.core import hybrid as jh
from repro.core import synapse as j_syn
from repro.core.anncore import AnnCore as JAnnCore
from repro.kernels.synray_sparse import ops as j_sparse_ops
from repro.kernels.synray_sparse.ref import sparse_window_ref as j_ref
from repro.obs import trace as obs_trace
from repro.verif.mismatch import sample_instance as j_sample_instance
from repro_torch import convert
from repro_torch.configs.bss2 import BSS2
from repro_torch.core import events as t_events
from repro_torch.core import hybrid as th
from repro_torch.core import synapse as t_syn
from repro_torch.core.anncore import AnnCore
from repro_torch.kernels.census import ops as t_census_ops
from repro_torch.kernels.stp_scan import ops as t_stp_ops
from repro_torch.kernels.synray_sparse import ops as t_sparse_ops
from repro_torch.kernels.synray_sparse.ref import sparse_window_ref
from repro_torch.obs import trace as t_trace
from repro_torch.verif.mismatch import sample_instance


def _operands(T, R, C, seed, p, prefix=(), n_addr=4, const=False):
    """Stores [*prefix, R, C], events [T, *prefix, R] with STP-like
    efficacies, event addresses (row-constant with ``const``) and a
    per-column gain."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 64, (*prefix, R, C)).astype(np.int8)
    shape = (T, *prefix, R)
    ev = ((rng.random(shape) < p)
          * rng.uniform(0.1, 1.5, shape)).astype(np.float32)
    if const:
        row_addr = rng.integers(0, 64, (*prefix, R)).astype(np.int8)
        ea = np.broadcast_to(row_addr, shape).copy()
        a = np.broadcast_to(row_addr[..., None], (*prefix, R, C)).copy()
    else:
        ea = rng.integers(0, n_addr, shape).astype(np.int8)
        a = rng.integers(0, n_addr, (*prefix, R, C)).astype(np.int8)
    gain = (1 + 0.2 * rng.standard_normal((*prefix, C))).astype(np.float32)
    return w, a, ev, ea, gain


def _folded(T, R, C, N, seed, p):
    """[N, T, R] windows and [N, R, C] stores."""
    w, a, ev, ea, _ = _operands(T, R, C, seed, p, prefix=(N,))
    return w, a, ev.transpose(1, 0, 2).copy(), ea.transpose(1, 0, 2).copy()


class TestKernelPlain:
    @pytest.mark.parametrize("p", [0.0, 0.01, 0.1, 0.5, 1.0])
    def test_plain_matches_reference_ref(self, p):
        """Same regrouped records in, the reference's gather-einsum out."""
        N, T, R, C = 3, 32, 40, 48
        w, a, ev, ea = _folded(T, R, C, N, seed=1, p=p)

        def one(e, d):
            return je.regroup_events(je.pack_events(e, d, T * R), T, R)
        recs = [np.asarray(x) for x in jax.vmap(one)(ev, ea)]
        want = np.asarray(jax.vmap(j_ref)(*recs, w, a))
        got = sparse_window_ref(*(t(x) for x in recs), t(w), t(a))
        close(got, want)
        # one instance, 2-D operands
        got1 = sparse_window_ref(*(t(x[0]) for x in recs), t(w[0]), t(a[0]))
        close(got1, want[0])

    @pytest.mark.parametrize("max_events,k_cap", [(10_000, 40), (60, 40),
                                                  (10_000, 2), (None, None)])
    def test_synaptic_current_sparse_matches_reference(self, max_events,
                                                       k_cap):
        """The whole path, packing and drops included (undersized
        capacities drop the same records in both packages)."""
        N, T, R, C = 2, 24, 32, 40
        if max_events is None:
            max_events = je.default_max_events(T, R, 0.05)
            k_cap = je.default_k_cap(R, 0.05)
        w, a, ev, ea = _folded(T, R, C, N, seed=2, p=0.08)
        want = j_sparse_ops.synaptic_current_sparse(
            ev, ea, w, a, max_events=max_events, k_cap=k_cap, impl="ref")
        got = t_sparse_ops.synaptic_current_sparse(
            t(ev), t(ea), t(w), t(a), max_events=max_events, k_cap=k_cap)
        assert got.shape == (N, T, C) and got.dtype == torch.float32
        close(got, want)

    # (density, max_events, k_cap, -0.0 efficacies)
    WINDOW_CASES = {"fits": (0.03, 10_000, 40, False),
                    "max_events": (0.08, 60, 40, False),
                    "k_cap": (0.08, 10_000, 2, False),
                    "both": (0.3, 90, 3, False),
                    "neg_zero": (0.08, 10_000, 40, True),
                    "empty": (0.0, 50, 4, False),
                    "all_fire": (1.0, 24 * 32, 32, False)}

    @pytest.mark.parametrize("case", sorted(WINDOW_CASES))
    def test_window_form_matches_reference(self, case):
        """The window form's plain version on both Dale halves of a
        time-major window read in place, against the reference's
        pack-regroup-compute path and its forced sparse route, drops
        included."""
        p, max_events, k_cap, neg = self.WINDOW_CASES[case]
        N, T, R, C = 2, 24, 64, 40
        w, a, ev, ea, gain = _operands(T, R, C, seed=12, p=p, prefix=(N,))
        if neg:
            z = ev == 0
            ev[z] = np.where(np.random.default_rng(13).random(
                int(z.sum())) < 0.5, -0.0, 0.0)
            assert (np.signbit(ev) & (ev == 0)).any()
        kw = dict(max_events=max_events, k_cap=k_cap)
        for h in (0, 1):
            v = (ev[..., h::2], ea[..., h::2], w[:, h::2], a[:, h::2])
            got = t_sparse_ops.sparse_current_window(*(t(x)[...] for x in v),
                                                     **kw)
            tv = [t(x) for x in (ev, ea, w, a)]
            in_place = t_sparse_ops.sparse_current_window(
                tv[0][..., h::2], tv[1][..., h::2], tv[2][:, h::2],
                tv[3][:, h::2], **kw)
            assert torch.equal(got, in_place)
            want = j_sparse_ops.synaptic_current_sparse(
                v[0].transpose(1, 0, 2), v[1].transpose(1, 0, 2), v[2],
                v[3], impl="ref", **kw)
            assert got.shape == (T, N, C)
            close(got, np.asarray(want).transpose(1, 0, 2))
            forced = t_syn.synaptic_current_window(
                tv[2][:, h::2], tv[3][:, h::2], tv[0][..., h::2],
                tv[1][..., h::2], t(gain), sparse="always", **kw)
            close(forced, j_syn.synaptic_current_window(
                *v[2:], v[0], v[1], gain, sparse="always", **kw))
        if case == "empty":
            assert float(got.abs().max()) == 0.0

    def test_wrapper_dispatch(self):
        """CPU tensors run the plain version and count no launch."""
        from repro_torch import kernels
        N, T, R, C = 2, 8, 16, 16
        w, a, ev, ea = _folded(T, R, C, N, seed=3, p=0.2)
        recs = t_sparse_ops.events.regroup_window(t(ev), t(ea), T * R, R)
        n0 = kernels.LAUNCHES["synray_sparse"]
        got = t_sparse_ops.sparse_window(*recs, t(w), t(a))
        assert kernels.LAUNCHES["synray_sparse"] == n0
        torch.testing.assert_close(got, sparse_window_ref(*recs, t(w), t(a)),
                                   rtol=0, atol=0)


def _ref_route(w, a, ev, ea, gain, **kw):
    """The reference's currents and route ("dense" | "sparse") of one
    window, read from its telemetry counters."""
    i, tele = j_syn.synaptic_current_window(
        w, a, ev, ea, gain, telemetry=obs_trace.init_telemetry(), **kw)
    assert int(tele.sparse_windows) + int(tele.dense_windows) == 1
    return np.asarray(i), ("sparse" if int(tele.sparse_windows) else "dense")


class TestGate:
    T, R, C = 64, 128, 256    # T*R*C = 2M: at the static floor

    @pytest.mark.parametrize("sparse", ["never", "always", "auto"])
    @pytest.mark.parametrize("p", [0.004, 0.03, 0.2])
    @pytest.mark.parametrize("const_addr", [False, True])
    def test_modes_match_reference(self, sparse, p, const_addr):
        w, a, ev, ea, gain = _operands(self.T, self.R, self.C, seed=4, p=p,
                                       const=const_addr)
        kw = dict(const_addr=const_addr, sparse=sparse)
        want, want_route = _ref_route(w, a, ev, ea, gain, **kw)
        route, _, _ = t_syn.window_route(t(ev), self.C, **kw)
        assert route == want_route
        got = t_syn.synaptic_current_window(t(w), t(a), t(ev), t(ea),
                                            t(gain), **kw)
        close(got, want)

    @pytest.mark.parametrize("p_worst,expect", [(0.004, "sparse"),
                                                (0.1, "dense")])
    def test_instance_prefix_worst_instance_decides(self, p_worst, expect):
        """One decision per call, on the worst instance of the fleet: one
        dense instance among sparse ones sends the whole call dense,
        though the fleet's mean would fit."""
        w, a, ev, ea, gain = _operands(self.T, self.R, self.C, seed=5,
                                       p=0.004, prefix=(3,))
        fired = np.random.default_rng(6).random((self.T, self.R)) < p_worst
        ev[:, 1] = np.where(fired, np.float32(0.7), ev[:, 1])
        want, want_route = _ref_route(w, a, ev, ea, gain, sparse="auto")
        route, max_events, _ = t_syn.window_route(t(ev), self.C,
                                                  sparse="auto")
        assert route == want_route == expect
        assert int((ev != 0).sum()) / 3 < max_events
        got = t_syn.synaptic_current_window(t(w), t(a), t(ev), t(ea),
                                            t(gain))
        close(got, want)

    @pytest.mark.parametrize("p", [0.004, 0.03, 0.2])
    @pytest.mark.parametrize("const_addr", [False, True])
    def test_census_flag_matches_reference(self, p, const_addr):
        """The gate's plain version: ``kernels.census`` gives the flag and
        the census as an int32 [3] tensor, equal to the reference's
        ``window_stats`` and ``census_fits`` at the default capacities,
        and ``window_route`` adds its decision to ``route_counts``."""
        w, a, ev, ea, gain = _operands(self.T, self.R, self.C, seed=4, p=p,
                                       const=const_addr)
        thr = (j_syn.SPARSE_THRESHOLD_CONST_ADDR if const_addr
               else j_syn.SPARSE_THRESHOLD)
        me = je.default_max_events(self.T, self.R, thr)
        kc = je.default_k_cap(self.R, thr)
        n, k = je.window_stats(ev)
        fits = bool(je.census_fits(n, k, me, kc))
        got = t_census_ops.census(t(ev), me, kc)
        assert got.dtype == torch.int32
        assert got.tolist() == [int(fits), int(n), int(k)]
        counts = t_syn.route_counts("cpu")
        before = counts.clone()
        route, _, _ = t_syn.window_route(t(ev), self.C, const_addr=const_addr)
        assert route == ("sparse" if fits else "dense")
        assert (counts - before).tolist() == [int(not fits), int(fits)]

    @pytest.mark.parametrize("p_worst", [0.004, 0.1])
    def test_gated_window_matches_reference(self, p_worst):
        """The device's form of the gate, run with the plain versions: the
        census's flag lets the sparse route compute where the window fits
        and the dense one where it does not, into one buffer; one dense
        instance among sparse ones sends the call dense. Against the
        reference's ``lax.cond`` route."""
        w, a, ev, ea, gain = _operands(self.T, self.R, self.C, seed=5,
                                       p=0.004, prefix=(3,))
        fired = np.random.default_rng(6).random((self.T, self.R)) < p_worst
        ev[:, 1] = np.where(fired, np.float32(0.7), ev[:, 1])
        want, want_route = _ref_route(w, a, ev, ea, gain, sparse="auto")
        me = je.default_max_events(self.T, self.R, j_syn.SPARSE_THRESHOLD)
        kc = je.default_k_cap(self.R, j_syn.SPARSE_THRESHOLD)
        counts = t_syn.route_counts("cpu")
        before = counts.clone()
        got = t_syn._gated_window(t(w), t(a), t(ev), t(ea), t(gain), False,
                                  me, kc)
        close(got, want)
        fits = want_route == "sparse"
        assert (counts - before).tolist() == [int(not fits), int(fits)]

    def test_below_floor_is_dense(self):
        w, a, ev, ea, gain = _operands(13, 16, 16, seed=7, p=0.01)
        want, want_route = _ref_route(w, a, ev, ea, gain, sparse="auto")
        assert want_route == "dense"
        assert t_syn.window_route(t(ev), 16)[0] == "dense"

    def test_const_addr_lowers_crossover(self):
        """tests/test_sparse.py::TestAutoGate's case: at a density
        between the two thresholds the generic gate routes sparse, the
        const_addr gate dense; across the routes the currents agree to
        1e-4."""
        T, R, C = 128, 128, 256
        w, a, ev, ea, gain = _operands(T, R, C, seed=71, p=0.03,
                                       const=True)
        n, _ = je.window_stats(ev)
        assert (j_syn.SPARSE_THRESHOLD_CONST_ADDR * T * R < int(n)
                <= j_syn.SPARSE_THRESHOLD * T * R)
        assert (t_syn.SPARSE_THRESHOLD, t_syn.SPARSE_THRESHOLD_CONST_ADDR,
                t_syn.SPARSE_MIN_DENSE_WORK) == (
            j_syn.SPARSE_THRESHOLD, j_syn.SPARSE_THRESHOLD_CONST_ADDR,
            j_syn.SPARSE_MIN_DENSE_WORK)
        outs = {}
        for const_addr, expect in ((False, "sparse"), (True, "dense")):
            want, want_route = _ref_route(w, a, ev, ea, gain,
                                          const_addr=const_addr)
            route, _, _ = t_syn.window_route(t(ev), C, const_addr=const_addr)
            assert want_route == route == expect
            outs[const_addr] = t_syn.synaptic_current_window(
                t(w), t(a), t(ev), t(ea), t(gain), const_addr=const_addr)
            close(outs[const_addr], want)
        close(outs[False], outs[True])


class TestOverflowContract:
    T, R, C = 64, 64, 512

    def _ops(self):
        w, a, ev, ea, _ = _operands(self.T, self.R, self.C, seed=51, p=0.5)
        return t(w), t(a), t(ev), t(ea)

    def test_forced_sparse_overflow_diverges(self):
        w, a, ev, ea = self._ops()
        dense = t_syn.synaptic_current_window(w, a, ev, ea, 1.0,
                                              sparse="never")
        n = int((ev != 0).sum())
        for max_events, k_cap in ((n // 4, self.R), (self.T * self.R, 2)):
            forced = t_syn.synaptic_current_window(
                w, a, ev, ea, 1.0, sparse="always", max_events=max_events,
                k_cap=k_cap)
            assert float((forced - dense).abs().max()) > 0
            auto = t_syn.synaptic_current_window(
                w, a, ev, ea, 1.0, sparse="auto", max_events=max_events,
                k_cap=k_cap)
            assert torch.equal(auto, dense)


CFG = dataclasses.replace(BSS2.reduced(), n_rows=16, n_cols=16)


@pytest.mark.parametrize("backend", ["fused", "blocked"])
def test_anncore_sparse_matches_dense(backend):
    """sparse_mode="always" against "never" on one core of the port: the
    whole run, spikes and final state. The window's density fits the
    default capacities of each Dale half, so the forced route drops
    nothing."""
    inst = sample_instance(CFG, torch.Generator().manual_seed(0), (),
                           device="cpu")
    dense = AnnCore(CFG, inst, backend=backend, sparse_mode="never")
    sparse = AnnCore(CFG, inst, backend=backend, sparse_mode="always")
    rng = np.random.default_rng(9)
    st = dense.init_state(())
    st = st._replace(syn=st.syn._replace(
        weights=t(rng.integers(20, 64, (16, 16)).astype(np.int8)),
        addresses=t(rng.integers(0, 4, (16, 16)).astype(np.int8))))
    T = 200
    ev = t((rng.random((T, 16)) < 0.03).astype(np.float32))
    ad = t(rng.integers(0, 4, (T, 16)).astype(np.int8))
    thr = t_syn.SPARSE_THRESHOLD
    for h in (0, 1):
        n, kmax = t_events.window_stats(ev[:, h::2])
        assert bool(t_events.census_fits(
            n, kmax, t_events.default_max_events(T, 8, thr),
            t_events.default_k_cap(8, thr)))
    s1, o1 = dense.run(st, ev, ad, record_v=True)
    s2, o2 = sparse.run(st, ev, ad, record_v=True)
    assert float(o1["spikes"].sum()) > 0
    p = inst["neuron_params"]
    assert_spikes_match(o2["spikes"], o1["spikes"], o2["v"], o1["v"],
                        spike_threshold({k: v.numpy() for k, v in p.items()}))
    np.testing.assert_array_equal(o1["spikes"].numpy(), o2["spikes"].numpy())
    for x, y in zip(convert.to_numpy(s1), convert.to_numpy(s2)):
        for a, b in zip(jax.tree.leaves(x), jax.tree.leaves(y)):
            close(a, b)


@pytest.mark.parametrize("const_addr", [False, True])
@pytest.mark.parametrize("backend", ["fused", "blocked"])
@pytest.mark.parametrize("density", ["fits", "overflows", "exc_overflows"])
def test_anncore_gate_in_the_scan_matches_reference(monkeypatch, density,
                                                    backend, const_addr):
    """A windowed core above the census floor (two instances of 128 rows
    x 256 columns, T = 128: both Dale halves gated): the STP scan takes
    both censuses (the census kernel's wrapper is not called) and each
    half routes on its own. Against the reference's ``_window_currents``
    with telemetry on the same instance, state and events: the currents
    within the house tolerance, the STP state, the decisions added to
    ``route_counts`` and every telemetry counter equal."""
    T, R, C, prefix = 128, 128, 256, (2,)
    cfg_j = dataclasses.replace(J_BSS2, n_rows=R, n_cols=C)
    cfg_t = dataclasses.replace(BSS2, n_rows=R, n_cols=C)
    inst = jax.tree.map(np.asarray, j_sample_instance(
        cfg_j, jax.random.PRNGKey(8), prefix))
    j_core = JAnnCore(cfg_j, inst, backend="fused", const_addr=const_addr)
    core = AnnCore(cfg_t, convert.instance(inst, "cpu"), backend=backend,
                   const_addr=const_addr)
    rng = np.random.default_rng(21)
    state_j = j_core.init_state(prefix)
    state_j = state_j._replace(syn=state_j.syn._replace(
        weights=rng.integers(0, 64, (*prefix, R, C)).astype(np.int8)))
    state_t = convert.core_state(jax.tree.map(np.asarray, state_j), "cpu")
    p = {"fits": (0.008, 0.008), "overflows": (0.1, 0.1),
         "exc_overflows": (0.1, 0.008)}[density]
    ev = np.zeros((T, *prefix, R), np.float32)
    for h in (0, 1):
        ev[..., h::2] = rng.random((T, *prefix, R // 2)) < p[h]
    ad = np.zeros(ev.shape, np.int8)

    census_calls, caps = [], []
    real_census, real_scan = t_census_ops.census, t_stp_ops.stp_scan

    def scan_spy(*args, **kw):
        caps.append(kw.get("caps"))
        return real_scan(*args, **kw)
    monkeypatch.setattr(t_census_ops, "census",
                        lambda *a, **k: census_calls.append(1)
                        or real_census(*a, **k))
    monkeypatch.setattr(t_stp_ops, "stp_scan", scan_spy)
    counts = t_syn.route_counts("cpu")
    before = counts.clone()
    s_t, ie_t, ii_t, tele_t = core._window_currents(
        state_t, t(ev), t(ad), telemetry=t_trace.init_telemetry("cpu"))
    s_j, ie_j, ii_j, tele_j = j_core._window_currents(
        state_j, ev, ad, unroll=1, telemetry=obs_trace.init_telemetry())
    assert census_calls == [] and caps[0] is not None
    close(ie_t, ie_j)
    close(ii_t, ii_j)
    close(s_t.r, s_j.r)
    want = obs_trace.summary(tele_j)
    assert t_trace.summary(tele_t) == want
    assert want["gated_windows"] == 2
    assert want["sparse_windows"] == {"fits": 2, "overflows": 0,
                                      "exc_overflows": 1}[density]
    assert (counts - before).tolist() == [want["dense_windows"],
                                          want["sparse_windows"]]


def test_teacher_forced_trials_above_floor(monkeypatch):
    """64 inputs x 256 neurons, T = 128 (T*R*C = 2.1M, above the floor):
    a no-stimulus trial, whose background fits the const_addr capacities
    (sparse), and a pattern trial, whose bursts overflow k_cap (dense).
    The reference's instance and draws go into the port; every window
    must take the reference's route and the trial's outputs agree."""
    ecfg = th.RSTDPConfig(n_inputs=64, n_neurons=256, pattern_size=16,
                          trial_steps=128)
    j_ecfg = jh.RSTDPConfig(n_inputs=64, n_neurons=256, pattern_size=16,
                            trial_steps=128)
    cfg_j = dataclasses.replace(J_BSS2, n_rows=128, n_cols=256)
    cfg_t = dataclasses.replace(BSS2, n_rows=128, n_cols=256)
    key0 = jax.random.PRNGKey(3)
    init, trial_j, meta_j = jh.make_experiment(cfg=cfg_j, ecfg=j_ecfg,
                                               instance_key=key0)
    inst = jax.tree.map(np.array, meta_j["inst"])
    tele_core = JAnnCore(cfg_j, inst, backend="fused", const_addr=True,
                         telemetry=True)
    _, trial_t, meta_t = th.make_experiment(
        cfg=cfg_t, ecfg=ecfg, inst=convert.instance(inst, "cpu"),
        device="cpu")

    routes = []
    real_route = t_syn.window_route

    def spy(*args, **kw):
        out = real_route(*args, **kw)
        routes.append(out[0])
        return out
    monkeypatch.setattr(t_syn, "window_route", spy)

    state_j = init(jax.random.PRNGKey(4))
    state_t = convert.experiment_state(jax.tree.map(np.asarray, state_j),
                                       "cpu")
    for stim, expect in ((0, "sparse"), (1, "dense")):
        draws = convert.replay_reference_draws(
            jax.random, state_j.key, [stim], ecfg, device="cpu")
        ev = draws.events[0]
        addr = np.zeros(ev.shape, np.int8)
        # the reference's routes for this window, from its counters
        ref_core = jax.tree.map(np.asarray, state_j.core)
        _, out = tele_core.run(ref_core, ev.numpy(), addr)
        tl = out["telemetry"]
        assert int(tl.gated_windows) == 2
        assert int(tl.sparse_windows) == (2 if expect == "sparse" else 0)
        routes.clear()
        new_t, m_t = trial_t(state_t, stim, ev, draws.xi[0])
        assert routes == [expect, expect]
        new_j, m_j = jax.jit(trial_j, static_argnums=1)(state_j, stim)
        np.testing.assert_array_equal(m_t["rates"].numpy(),
                                      np.asarray(m_j["rates"]))
        np.testing.assert_array_equal(m_t["reward"].numpy(),
                                      np.asarray(m_j["reward"]))
        np.testing.assert_array_equal(new_t.core.syn.weights.numpy(),
                                      np.asarray(new_j.core.syn.weights))
        close(new_t.w_signed, new_j.w_signed)
        close(new_t.core.neuron.v, new_j.core.neuron.v)
        assert float(m_t["rates"].sum()) > 0
        state_j, state_t = new_j, new_t
