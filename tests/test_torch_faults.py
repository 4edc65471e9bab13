"""Fault injection and defect tolerance in the port (``repro_torch.faults``)
against the reference (``repro.faults``).

- The fault model is a copy: the same ``FaultPlan`` fields from the same
  ``np.random.default_rng`` seeds, and ``chain`` / ``as_plans`` /
  ``total_sites`` / ``summary`` / ``remap_link_faults`` equal.
- Each of the eight hooks is tier 1 against the reference's on the same
  random plan and value, with multi-plan chains; a plan without the
  hook's field gives back the object it was given. ``cadc_map`` (the
  folded form ``ppu_update`` applies) equals the ``cadc`` hook on every
  code.
- A faulted ``AnnCore`` window per backend and per synaptic route against
  the reference's: spikes equal up to flips at threshold, floats within
  rtol = atol = 1e-4; inside the port every backend and route gives the
  same spikes under the same plan (tests/test_faults.py::TestInjection).
- ``VectorUnit``'s ``cadc`` and ``store`` hooks tier 1 (the cases of
  tests/test_faults.py:218-248); ``apply_rstdp`` with CADC faults equal
  to the hooked read followed by the rule.
- Screening: ``screen`` on the port equals the reference's on the same
  instance and plan (tier 1), the reference's core and vector unit built
  by its own ``make_experiment(faults=)``; ``TestBlacklist`` mirrored,
  reduction exactness per backend bit for bit.
- Playback: a faulted program gives the same records on ``FastBackend``
  and ``RefBackend``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_parity import assert_spikes_match, close, spike_threshold, t
from repro.configs.bss2 import BSS2 as J_BSS2
from repro.core import hybrid as jh
from repro.core.anncore import AnnCore as JAnnCore
from repro.core.ppu import VectorUnit as JVectorUnit
from repro.faults import blacklist as j_blacklist
from repro.faults import inject as j_inject
from repro.faults import model as j_model
from repro.verif.mismatch import sample_instance as j_sample_instance
from repro.wafer import WaferTopology
from repro_torch import convert
from repro_torch.configs.bss2 import BSS2
from repro_torch.core import hybrid as th
from repro_torch.core import synapse
from repro_torch.core.anncore import AnnCore
from repro_torch.core.ppu import VectorUnit
from repro_torch.faults import (Blacklist, FaultPlan, cadc_zero_code, chain,
                                remap_link_faults, sample_fault_plan, screen,
                                screen_chip, screen_links)
from repro_torch.faults import inject
from repro_torch.faults import model as t_model
from repro_torch.obs import trace as obs_trace
from repro_torch.ppuvm import programs

R, C, T = 16, 8, 48
BACKENDS = ("oracle", "fused", "blocked")
CFG = dataclasses.replace(BSS2.reduced(), n_rows=R, n_cols=C)
CFG_J = dataclasses.replace(J_BSS2.reduced(), n_rows=R, n_cols=C)


def _inst(prefix=(), cfg=CFG_J, key=0):
    """The reference's instance (numpy) and the port's copy of it."""
    inst = jax.tree.map(np.asarray, j_sample_instance(
        cfg, jax.random.PRNGKey(key), prefix))
    return inst, convert.instance(inst, "cpu")


def _events(key=1, p=0.25, t_=T, r=R):
    ev = np.asarray(jax.random.uniform(jax.random.PRNGKey(key), (t_, r))
                    < p, np.float32)
    return ev, np.zeros((t_, r), np.int8)


def _covered_plan(rng):
    """tests/test_faults.py::_covered_plan: every site on a row or column
    the commissioning probes blacklist."""
    dead_rows = np.zeros(R, bool)
    dead_rows[[2, 7, 11]] = True
    hot = np.zeros(C, bool)
    hot[1] = True
    dead_n = np.zeros(C, bool)
    dead_n[5] = True
    badcol = hot | dead_n
    sw_mask = np.zeros((R, C), bool)
    sw_mask[dead_rows] = rng.random((3, C)) < 0.5
    sw_mask[:, badcol] |= rng.random((R, 2)) < 0.5
    sf = np.where(sw_mask, 1 << rng.integers(0, 6, (R, C)), 0)
    return FaultPlan(
        dead_rows=dead_rows, hot_neurons=hot, dead_neurons=dead_n,
        stuck_w_mask=sw_mask,
        stuck_w_val=rng.integers(0, 64, (R, C)).astype(np.int8),
        cadc_stuck_mask=badcol,
        cadc_stuck_code=rng.integers(0, 256, C).astype(np.int32),
        store_flip=sf.astype(np.int32))


def _as_ref(plan):
    """The port's plan as the reference's ``FaultPlan``."""
    return j_model.FaultPlan(**{f.name: getattr(plan, f.name)
                                for f in dataclasses.fields(plan)})


def _full_plan(rng, r=R, c=C, prefix=(), n_links=0):
    """A plan with every field, for the hook comparisons."""
    p = sample_fault_plan(r, c, rng, p_dead_row=0.2, p_dead_neuron=0.2,
                          p_hot_neuron=0.2, p_stuck_w=0.2, p_cadc=0.3,
                          p_store_flip=0.2, n_links=n_links,
                          p_dead_link=0.3, p_flaky_link=0.5, prefix=prefix,
                          seed=int(rng.integers(0, 2**31)))
    kw = {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}
    kw.update(cadc_code_offset=rng.integers(-20, 21, (*prefix, c)),
              store_zero=rng.random((*prefix, r, c)) < 0.2)
    return FaultPlan(**kw)


# ---------------------------------------------------------------------------
# The model: a copy of the reference's
# ---------------------------------------------------------------------------

class TestModel:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    @pytest.mark.parametrize("kw", [
        dict(p_dead_row=0.1, p_stuck_w=0.01, n_links=16, p_dead_link=0.5,
             p_flaky_link=0.5, flaky_drop=0.25),
        dict(p_dead_row=0.06, p_hot_neuron=0.25, p_cadc=0.12, seed=1),
        dict(p_dead_row=0.02, p_dead_neuron=0.01, p_hot_neuron=0.01,
             p_stuck_w=0.001, p_cadc=0.02, prefix=(2,), seed=1,
             p_store_flip=0.01)])
    def test_sample_plan_equal_to_reference(self, seed, kw):
        a = sample_fault_plan(64, 32, np.random.default_rng(seed), **kw)
        b = j_model.sample_fault_plan(64, 32, np.random.default_rng(seed),
                                      **kw)
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(y, np.ndarray):
                assert x.dtype == y.dtype, f.name
                np.testing.assert_array_equal(x, y, err_msg=f.name)
            else:
                assert x == y, f.name
        assert a.total_sites == b.total_sites
        assert a.core_sites == b.core_sites and a.link_sites == b.link_sites
        assert a.summary() == b.summary()

    def test_chain_census_and_remap_equal_to_reference(self):
        rng = np.random.default_rng(4)
        p1, p2 = _full_plan(rng, n_links=3), _full_plan(rng, n_links=3)
        j1, j2 = _as_ref(p1), _as_ref(p2)
        assert [q.summary() for q in chain(p1, (None, p2), None)] == \
            [q.summary() for q in j_model.chain(j1, (None, j2), None)]
        assert chain(None, None) is None and j_model.chain(None) is None
        assert t_model.as_plans(p1) == (p1,) and t_model.as_plans(None) == ()
        old = WaferTopology(3, "ring").links()
        new = WaferTopology(3, "all2all").links()
        a = remap_link_faults(p1, old, new)
        b = j_model.remap_link_faults(j1, old, new)
        np.testing.assert_array_equal(a.dead_links, b.dead_links)
        np.testing.assert_array_equal(a.flaky_links, b.flaky_links)
        assert a.summary() == b.summary()

    # tests/test_faults.py::TestModel, on the copy
    def test_plan_validation(self):
        with pytest.raises(ValueError):
            FaultPlan(stuck_w_mask=np.zeros((R, C), bool))
        with pytest.raises(ValueError):
            FaultPlan(cadc_stuck_code=np.zeros(C, np.int32))
        with pytest.raises(AssertionError):
            FaultPlan(stuck_w_mask=np.ones((R, C), bool),
                      stuck_w_val=np.full((R, C), 64))
        with pytest.raises(AssertionError):
            FaultPlan(flaky_links=np.array([1.5]))

    def test_chain_and_site_census(self):
        fp = FaultPlan(dead_rows=np.eye(1, R, 3, dtype=bool)[0])
        assert fp.total_sites == 1 and fp.n_dead_rows == 1
        assert chain(fp) == (fp,)
        assert chain(fp, (fp, None), None) == (fp, fp)
        assert "dead_rows" in fp.summary()

    def test_sample_plan_rates(self):
        fp = sample_fault_plan(256, 256, np.random.default_rng(0),
                               p_dead_row=0.1, p_stuck_w=0.01, n_links=16,
                               p_dead_link=0.5, p_flaky_link=0.5,
                               flaky_drop=0.25)
        assert 10 <= fp.n_dead_rows <= 45
        assert not (fp.dead_links & (fp.flaky_links > 0)).any()

    def test_remap_link_faults(self):
        old = WaferTopology(3, "ring").links()
        new = WaferTopology(3, "all2all").links()
        fp = FaultPlan(dead_links=np.array([False, True, False]),
                       flaky_links=np.array([0.5, 0.0, 0.0], np.float32))
        fp2 = remap_link_faults(fp, old, new)
        assert fp2.dead_links[new.index((1, 2))]
        assert fp2.dead_links.sum() == 1
        assert fp2.flaky_links[new.index((0, 1))] == np.float32(0.5)


# ---------------------------------------------------------------------------
# The hooks, tier 1 against the reference's
# ---------------------------------------------------------------------------

def _hook_inputs(rng, prefix):
    ev = (rng.random((T, *prefix, R)) < 0.3).astype(np.float32)
    w = rng.integers(0, 64, (*prefix, R, C)).astype(np.int8)
    sp = (rng.random((T, *prefix, C)) < 0.3).astype(np.float32)
    rc_in = rng.integers(0, 5, (*prefix, C)).astype(np.float32)
    rc = rc_in + sp.sum(0)
    q = rng.integers(0, 256, (2, *prefix, R, C)).astype(np.int32)
    wn = rng.integers(0, 64, (*prefix, R, C)).astype(np.int32)
    return dict(ev=ev, w=w, sp=sp, rc=rc, rc_in=rc_in, q=q, wn=wn)


def _apply(mod, name, faults, x, as_tensor):
    if name == "rows":
        return [mod.rows(faults, as_tensor(x["ev"]))]
    if name == "weights":
        return [mod.weights(faults, as_tensor(x["w"]))]
    if name == "spikes":
        return [mod.spikes(faults, as_tensor(x["sp"]))]
    if name == "rates":
        return [mod.rates(faults, as_tensor(x["rc"]), as_tensor(x["rc_in"]),
                          T)]
    if name == "cadc":
        return list(mod.cadc(faults, as_tensor(x["q"][0]),
                             as_tensor(x["q"][1]), 255))
    return [mod.store(faults, as_tensor(x["wn"]))]


HOOKS = ("rows", "weights", "spikes", "rates", "cadc", "store")


@pytest.mark.parametrize("name", HOOKS)
@pytest.mark.parametrize("prefix", [(), (2,)])
@pytest.mark.parametrize("n_plans", [1, 2])
def test_hook_equal_to_reference(name, prefix, n_plans):
    rng = np.random.default_rng(hash((name, prefix, n_plans)) % 2**32)
    plans = [_full_plan(rng, prefix=prefix) for _ in range(n_plans)]
    x = _hook_inputs(rng, prefix)
    want = _apply(j_inject, name, tuple(_as_ref(p) for p in plans), x,
                  jax.numpy.asarray)
    got = _apply(inject, name, inject.on_device(plans, "cpu"), x, t)
    host = _apply(inject, name, tuple(plans), x, t)     # host plans
    for g, h, w in zip(got, host, want):
        assert str(g.dtype).split(".")[-1] == str(np.asarray(w).dtype)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert torch.equal(g, h)


@pytest.mark.parametrize("name", HOOKS)
def test_hook_without_its_field_returns_its_argument(name):
    """A plan with no field for the hook (and ``None``) gives back the
    object it was given: no operation at all."""
    x = _hook_inputs(np.random.default_rng(0), ())
    empty = FaultPlan(dead_links=np.zeros(2, bool))
    for faults in (None, empty, (empty, empty)):
        args = {k: t(v) for k, v in x.items()}
        if name == "rows":
            assert inject.rows(faults, args["ev"]) is args["ev"]
        elif name == "weights":
            assert inject.weights(faults, args["w"]) is args["w"]
        elif name == "spikes":
            assert inject.spikes(faults, args["sp"]) is args["sp"]
        elif name == "rates":
            assert inject.rates(faults, args["rc"], args["rc_in"],
                                T) is args["rc"]
        elif name == "cadc":
            qc, qa = args["q"][0], args["q"][1]
            out = inject.cadc(faults, qc, qa, 255)
            assert out[0] is qc and out[1] is qa
        else:
            assert inject.store(faults, args["wn"]) is args["wn"]
    assert inject.on_device(None, "cpu") is None
    assert inject.cadc_map(None, "cpu", 255) is None


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("T_,n_links", [(16, 4), (64, 12)])
def test_link_hooks_equal_to_reference(seed, T_, n_links):
    """``link_keep`` (the flaky-drop hash on [T, R] grids) and ``links``
    tier 1 against the reference's, dead and flaky links, several plans,
    and a block of the link space."""
    rng = np.random.default_rng(seed)
    Rr = 24
    plans = [sample_fault_plan(Rr, 4, rng, n_links=n_links, p_dead_link=0.3,
                               p_flaky_link=0.6, flaky_drop=0.4,
                               seed=int(rng.integers(0, 2**32)))
             for _ in range(2)]
    ids = np.arange(n_links // 2, n_links)
    grids = rng.random((T_, len(ids), Rr)).astype(np.float32)
    for p in plans:
        got = inject.link_keep(inject.DevicePlan.build(p, "cpu"), T_, Rr,
                               ids)
        want = j_inject.link_keep(_as_ref(p), T_, Rr, ids)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = inject.links(inject.on_device(plans, "cpu"), t(grids), ids)
    want = j_inject.links(tuple(_as_ref(p) for p in plans),
                          jax.numpy.asarray(grids), ids)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert inject.has_link_faults(plans)
    g = t(grids)
    assert inject.links(FaultPlan(dead_rows=np.zeros(Rr, bool)), g, ids) is g


@pytest.mark.parametrize("seed", range(6))
def test_cadc_map_equals_the_hook_on_every_code(seed):
    """The folded clamp-shift equals the sequential ``cadc`` hook on every
    code 0..255 of every column, for chains of offsets and stuck codes
    (the blacklist's stuck columns last)."""
    rng = np.random.default_rng(seed)
    n = 8
    plans = []
    for _ in range(int(rng.integers(1, 4))):
        plans.append(FaultPlan(
            cadc_code_offset=(rng.integers(-300, 300, n)
                              if rng.random() < 0.8 else None),
            cadc_stuck_mask=(m := rng.random(n) < 0.3),
            cadc_stuck_code=rng.integers(0, 256, n).astype(np.int32)))
    plans.append(Blacklist(rows=np.zeros(4, bool),
                           neurons=rng.random(n) < 0.2).as_faults(
        dict(cadc_offset=rng.normal(0, 4, n).astype(np.float32))))
    del m
    codes = torch.arange(256, dtype=torch.int32)[:, None].expand(256, n)
    want, _ = inject.cadc(plans, codes, codes, 255)
    a, lo, hi = inject.cadc_map(plans, "cpu", 255)
    got = torch.minimum(torch.maximum(codes.float() + a, lo), hi)
    assert torch.equal(got, want.float())


# ---------------------------------------------------------------------------
# AnnCore under faults
# ---------------------------------------------------------------------------

def test_backends_consistent_under_faults():
    """The same plan gives identical spikes and rate counters on every
    backend and synaptic route (tests/test_faults.py::TestInjection::
    test_backend_consistent); hot columns always fire, dead ones never."""
    inst, inst_t = _inst()
    fp = sample_fault_plan(R, C, np.random.default_rng(0), p_dead_row=0.2,
                           p_dead_neuron=0.2, p_hot_neuron=0.1,
                           p_stuck_w=0.05, p_cadc=0.2)
    # a density whose Dale halves fit the default capacities: "always"
    # drops no record
    ev, ad = _events(p=0.06)
    assert (ev[:, 0::2].sum(), ev[:, 1::2].sum()) <= (32, 32)
    outs = {}
    for be in BACKENDS:
        for sparse in ("never", "always"):
            c = AnnCore(CFG, inst_t, backend=be, sparse_mode=sparse,
                        faults=fp)
            s, o = c.run(c.init_state(), t(ev), t(ad))
            outs[(be, sparse)] = (o["spikes"], s.rate_counters)
    ref = outs[("oracle", "never")]
    for k, (sp, rc) in outs.items():
        assert torch.equal(ref[0], sp), k
        assert torch.equal(ref[1], rc), k
    sp, rc = ref
    assert (sp[:, torch.as_tensor(fp.hot_neurons)] == 1.0).all()
    assert (sp[:, torch.as_tensor(fp.dead_neurons)] == 0.0).all()
    assert torch.equal(rc, sp.sum(0))


def _window_setup(rows, cols, steps, prefix, seed, p):
    cfg_j = dataclasses.replace(J_BSS2.reduced(), n_rows=rows, n_cols=cols)
    cfg = dataclasses.replace(BSS2.reduced(), n_rows=rows, n_cols=cols)
    inst, inst_t = _inst(prefix, cfg_j, key=seed)
    rng = np.random.default_rng(seed + 5)
    fp = sample_fault_plan(rows, cols, rng, p_dead_row=0.1,
                           p_dead_neuron=0.05, p_hot_neuron=0.05,
                           p_stuck_w=0.05, p_cadc=0.1, prefix=prefix)
    st = JAnnCore(cfg_j, inst).init_state(prefix)
    shape = (*prefix, rows, cols)
    st = st._replace(
        syn=st.syn._replace(
            weights=rng.integers(20, 64, shape).astype(np.int8)),
        neuron=st.neuron._replace(v=rng.uniform(
            -58, -45, (*prefix, cols)).astype(np.float32)))
    ev = (rng.random((steps, *prefix, rows)) < p).astype(np.float32)
    ad = np.zeros(ev.shape, np.int8)
    return cfg_j, cfg, inst, inst_t, fp, st, ev, ad


# the reduced window, and a 128 x 256 window whose Dale halves lie above
# the census floor (64 rows x 256 columns x 128 steps), where "auto" is
# decided by the census (sparse at this density)
WINDOWS = {"small": (R, C, T, (2,), 0.06),
           "gated": (128, 256, 128, (), 0.004)}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("route", ["never", "always", "auto"])
def test_faulted_window_matches_reference(backend, route):
    """One faulted window, teacher-forced from the reference's state and
    events (the oracle ignores the route: dense every step, on both
    window sizes): spikes equal up to flips at threshold, currents (the blocked
    and fused backends' window currents), membranes, traces, accumulators
    and STP resources within 1e-4, rate counters exact."""
    size = "gated" if route == "auto" else "small"
    rows, cols, steps, prefix, p = WINDOWS[size]
    cfg_j, cfg, inst, inst_t, fp, st, ev, ad = _window_setup(
        rows, cols, steps, prefix, 3, p)
    jcore = JAnnCore(cfg_j, inst, backend=backend, sparse_mode=route,
                     const_addr=True, faults=_as_ref(fp))
    core = AnnCore(cfg, inst_t, backend=backend, sparse_mode=route,
                   const_addr=True, faults=fp)
    st_t = convert.core_state(st, "cpu")
    j_state, j_out = jcore.run(st, ev, ad, record_v=True)
    synapse.reset_route_counts()
    t_state, t_out = core.run(st_t, t(ev), t(ad), record_v=True)
    if route == "auto" and backend != "oracle":
        # both Dale halves decided by the census: sparse
        assert synapse.route_counts("cpu").tolist() == [0, 2]
    assert float(np.asarray(j_out["spikes"]).sum()) > 0
    assert_spikes_match(t_out["spikes"], j_out["spikes"], t_out["v"],
                        j_out["v"], spike_threshold(inst["neuron_params"]))
    np.testing.assert_array_equal(t_state.rate_counters.numpy(),
                                  np.asarray(j_state.rate_counters))
    close(t_out["v"], j_out["v"])
    for a, b in zip(jax.tree.leaves(convert.to_numpy(t_state)),
                    jax.tree.leaves(jax.tree.map(np.asarray, j_state))):
        close(a, b)
    if backend != "oracle":
        ev_h = j_inject.rows(_as_ref(fp), ev)
        j_cur = jcore._window_currents(st, ev_h, ad, 4)
        t_cur = core._window_currents(st_t, inject.rows(core.faults, t(ev)),
                                      t(ad))
        for a, b in zip(t_cur[1:3], j_cur[1:3]):
            close(a, b)


def test_stuck_weights_analog_only():
    """Stuck cells corrupt the crossbar read; the stored state (what the
    PPU reads back) is untouched."""
    _, inst_t = _inst()
    mask = np.zeros((R, C), bool)
    mask[::2] = True
    fp = FaultPlan(stuck_w_mask=mask, stuck_w_val=np.zeros((R, C), np.int8))
    w0 = np.random.default_rng(1).integers(30, 60, (R, C)).astype(np.int8)
    for be in BACKENDS:
        c = AnnCore(CFG, inst_t, backend=be, faults=fp)
        st = c.init_state()
        st = st._replace(syn=st.syn._replace(weights=t(w0)))
        st, out = c.run(st, *map(t, _events()))
        np.testing.assert_array_equal(st.syn.weights.numpy(), w0)
        assert float(out["spikes"].sum()) == 0


def test_faults_none_is_the_identity():
    """``faults=None`` (and a plan with no core field) gives the same
    outputs as a core built without the argument."""
    _, inst_t = _inst()
    ev, ad = map(t, _events())
    for be in BACKENDS:
        base = AnnCore(CFG, inst_t, backend=be)
        assert base.faults is None
        outs = [AnnCore(CFG, inst_t, backend=be, faults=f).run(
            base.init_state(), ev, ad) for f in (None, FaultPlan(
                dead_links=np.zeros(3, bool)))]
        s0, o0 = base.run(base.init_state(), ev, ad)
        for s, o in outs:
            assert torch.equal(o["spikes"], o0["spikes"])
            for a, b in zip(th._leaves(s), th._leaves(s0)):
                assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# VectorUnit hooks
# ---------------------------------------------------------------------------

def _observed_state(inst, inst_t):
    jcore = JAnnCore(CFG_J, inst)
    st, _ = jcore.run(jcore.init_state(), *_events())
    st = jax.tree.map(np.asarray, st)
    return st, convert.core_state(st, "cpu")


def test_cadc_and_store_hooks():
    """tests/test_faults.py::TestInjection::test_cadc_and_store_hooks on
    the port, and tier 1 against the reference's vector unit."""
    inst, inst_t = _inst()
    off = np.full(C, 7, np.int32)
    stuck = np.zeros(C, bool)
    stuck[3] = True
    code = np.full(C, 200, np.int32)
    flip = np.zeros((R, C), np.int32)
    flip[0, :] = 1
    zero = np.zeros((R, C), bool)
    zero[1, :] = True
    fp = FaultPlan(cadc_code_offset=off, cadc_stuck_mask=stuck,
                   cadc_stuck_code=code, store_flip=flip, store_zero=zero)
    st, st_t = _observed_state(inst, inst_t)
    clean = VectorUnit(CFG, inst_t)
    faulted = VectorUnit(CFG, inst_t, faults=fp)
    qc0, _ = clean.read_correlation(st_t.corr)
    qc1, qa1 = faulted.read_correlation(st_t.corr)
    exp = np.clip(qc0.numpy() + 7, 0, 255)
    exp[:, 3] = 200
    np.testing.assert_array_equal(qc1.numpy(), exp)
    j_faulted = JVectorUnit(CFG_J, inst, faults=_as_ref(fp))
    jqc, jqa = j_faulted.read_correlation(st.corr)
    np.testing.assert_array_equal(qc1.numpy(), np.asarray(jqc))
    np.testing.assert_array_equal(qa1.numpy(), np.asarray(jqa))
    words = programs.rstdp_program(eta=0.0)               # dw == 0
    w0 = st_t.syn.weights.numpy()
    st2, _ = faulted.run_program_fixed(st_t, torch.as_tensor(words))
    w1 = st2.syn.weights.numpy()
    np.testing.assert_array_equal(w1[0], w0[0] ^ 1)
    np.testing.assert_array_equal(w1[1], np.zeros(C, np.int8))
    np.testing.assert_array_equal(w1[2:], w0[2:])
    jst2, _ = j_faulted.run_program_fixed(st, jax.numpy.asarray(words))
    np.testing.assert_array_equal(w1, np.asarray(jst2.syn.weights))


@pytest.mark.parametrize("seed", range(3))
def test_apply_rstdp_with_cadc_faults(seed):
    """``apply_rstdp`` under CADC offsets and stuck columns (the kernel's
    path: ``cadc_map`` inside ``ppu_update``'s plain version on the CPU)
    equals the hooked ``read_correlation`` followed by the rule, and the
    reference's ``ref`` branch: weight codes exact, eligibility equal
    (its codes exact); a plan without CADC fields is the unfaulted rule
    bit for bit."""
    inst, inst_t = _inst()
    rng = np.random.default_rng(seed)
    st, st_t = _observed_state(inst, inst_t)
    # accumulators spread over the ADC range so offsets and clips matter
    ac = rng.uniform(0, 40, (R, C)).astype(np.float32)
    aa = rng.uniform(0, 40, (R, C)).astype(np.float32)
    st = st._replace(corr=st.corr._replace(a_causal=ac, a_acausal=aa))
    st_t = convert.core_state(st, "cpu")
    fp = FaultPlan(cadc_code_offset=rng.integers(-40, 40, C),
                   cadc_stuck_mask=rng.random(C) < 0.3,
                   cadc_stuck_code=rng.integers(0, 256, C).astype(np.int32))
    bl = Blacklist(rows=np.zeros(R, bool), neurons=rng.random(C) < 0.25)
    overlay = chain(fp, bl.as_faults(inst_t))
    reward = rng.integers(0, 2, C).astype(np.float32)
    xi = (0.3 * rng.standard_normal((R, C))).astype(np.float32)
    rs = dict(mean_reward=t(np.full(C, 0.25, np.float32)))
    ppu = VectorUnit(CFG, inst_t, faults=overlay)
    s_k, _, elig_k = ppu.apply_rstdp(st_t, rs, reward=t(reward), eta=4.0,
                                     xi=t(xi))
    qc, qa = ppu.read_correlation(st_t.corr)
    elig = (qc - qa).to(torch.float32) * np.float32(1 / np.float32(255))
    w_new = (st_t.syn.weights.to(torch.float32)
             + (4.0 * (t(reward) - 0.25)).unsqueeze(-2) * elig + t(xi))
    assert torch.equal(elig_k, elig)
    assert torch.equal(s_k.syn.weights,
                       torch.clamp(torch.round(w_new), 0, 63).to(torch.int8))
    # the reference's ref branch (its xi drawn from its key: inject ours)
    j_ppu = JVectorUnit(CFG_J, inst, faults=tuple(
        _as_ref(p) for p in t_model.as_plans(overlay)))
    jqc, jqa = j_ppu.read_correlation(st.corr)
    np.testing.assert_array_equal(qc.numpy(), np.asarray(jqc))
    np.testing.assert_array_equal(qa.numpy(), np.asarray(jqa))
    np.testing.assert_array_equal(
        np.rint(elig_k.numpy() * 255),
        (np.asarray(jqc) - np.asarray(jqa)).astype(np.float32))
    s0, _, _ = VectorUnit(CFG, inst_t, faults=FaultPlan(
        store_zero=np.zeros((R, C), bool))).apply_rstdp(
        st_t, rs, reward=t(reward), eta=4.0, xi=t(xi))
    s1, _, _ = VectorUnit(CFG, inst_t).apply_rstdp(
        st_t, rs, reward=t(reward), eta=4.0, xi=t(xi))
    assert torch.equal(s0.syn.weights, s1.syn.weights)


# ---------------------------------------------------------------------------
# Screening and blacklists
# ---------------------------------------------------------------------------

class TestBlacklist:
    def test_screening_recovers_planted_sites(self):
        _, inst_t = _inst()
        fp = _covered_plan(np.random.default_rng(0))
        bl = screen_chip(AnnCore(CFG, inst_t, faults=fp),
                         VectorUnit(CFG, inst_t, faults=fp))
        np.testing.assert_array_equal(bl.rows, fp.dead_rows)
        np.testing.assert_array_equal(bl.neurons,
                                      fp.hot_neurons | fp.dead_neurons)

    def test_screening_clean_chip_is_empty(self):
        _, inst_t = _inst()
        bl = screen_chip(AnnCore(CFG, inst_t), VectorUnit(CFG, inst_t))
        assert bl.total == 0

    def test_cadc_zero_code(self):
        inst, inst_t = _inst()
        core = AnnCore(CFG, inst_t)
        qc, _ = VectorUnit(CFG, inst_t).read_correlation(
            core.init_state().corr)
        base = cadc_zero_code(inst_t, CFG.cadc_bits)
        np.testing.assert_array_equal(qc.numpy(),
                                      np.broadcast_to(base, (R, C)))
        np.testing.assert_array_equal(base, j_blacklist.cadc_zero_code(inst))

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_reduction_exactness(self, backend):
        """Faulted chip under its blacklist == clean reduced network, bit
        for bit, through emulation + a PPU-VM store."""
        _, inst_t = _inst()
        rng = np.random.default_rng(3)
        fp = _covered_plan(rng)
        bl = screen_chip(AnnCore(CFG, inst_t, faults=fp),
                         VectorUnit(CFG, inst_t, faults=fp))
        red = bl.as_faults(inst_t, CFG.cadc_bits)
        cov = bl.rows[:, None] | bl.neurons[None, :]
        assert (~fp.stuck_w_mask | cov).all()
        words = torch.as_tensor(programs.rstdp_program(eta=8.0))
        w0 = t(rng.integers(0, 64, (R, C)).astype(np.int8))
        ev, ad = map(t, _events())

        def run_with(ov):
            c = AnnCore(CFG, inst_t, backend=backend, faults=ov)
            p = VectorUnit(CFG, inst_t, faults=ov)
            st = c.init_state()
            st = st._replace(syn=st.syn._replace(weights=w0))
            st, out = c.run(st, ev, ad)
            st2, _ = p.run_program_fixed(st, words)
            return out["spikes"], st.rate_counters, st2.syn.weights

        for x, y in zip(run_with(chain(fp, red)), run_with(chain(red))):
            assert torch.equal(x, y)

    def test_reduction_counters(self):
        _, inst_t = _inst()
        fp = _covered_plan(np.random.default_rng(3))
        bl = screen_chip(AnnCore(CFG, inst_t, faults=fp),
                         VectorUnit(CFG, inst_t, faults=fp))
        ov = chain(fp, bl.as_faults(inst_t, CFG.cadc_bits))
        c = AnnCore(CFG, inst_t, faults=ov)
        _, out = c.run(c.init_state(), *map(t, _events()),
                       telemetry=obs_trace.init_telemetry("cpu"))
        s = obs_trace.summary(out["telemetry"])
        assert s["faults_injected"] == fp.total_sites
        assert s["faults_detected"] == bl.as_faults(inst_t).total_sites
        assert s["blacklisted_rows"] == bl.n_rows == 3

    def test_union_and_counts(self):
        a = Blacklist(rows=[True, False], neurons=[False, True],
                      links=((0, 1),))
        b = Blacklist(rows=[False, True], neurons=[False, False],
                      links=((2, 3), (0, 1)))
        u = a.union(b)
        assert u.n_rows == 2 and u.n_neurons == 1
        assert u.links == ((0, 1), (2, 3)) and u.total == 5


@pytest.mark.parametrize("plan", ["covered", "sampled"])
def test_screen_equal_to_reference(plan):
    """``screen`` at 32 x 16 on the §5 instance: rows and neurons equal to
    the reference's ``screen`` of the same instance and plan. The
    reference's core and vector unit come from its own
    ``make_experiment(faults=)`` (not a finished run's ``meta``, whose
    instance arrays its training donated)."""
    rng = np.random.default_rng(3)
    if plan == "sampled":
        fp = sample_fault_plan(32, 16, rng, p_dead_row=0.06,
                               p_hot_neuron=0.25, p_dead_neuron=0.1,
                               p_cadc=0.12, seed=1)
    else:
        fp = FaultPlan(dead_rows=np.eye(1, 32, 9, dtype=bool)[0],
                       hot_neurons=np.eye(1, 16, 4, dtype=bool)[0],
                       cadc_stuck_mask=np.eye(1, 16, 11, dtype=bool)[0],
                       cadc_stuck_code=np.full(16, 90, np.int32))
    _, _, jmeta = jh.make_experiment(instance_key=jax.random.PRNGKey(1),
                                     faults=_as_ref(fp))
    want = j_blacklist.screen(jmeta["core"], jmeta["ppu"])
    inst = convert.instance(jax.tree.map(np.array, jmeta["inst"]), "cpu")
    _, _, meta = th.make_experiment(inst=inst, faults=fp, device="cpu")
    got = screen(meta["core"], meta["ppu"])
    np.testing.assert_array_equal(got.rows, want.rows)
    np.testing.assert_array_equal(got.neurons, want.neurons)
    assert got.total > 0


def test_link_screening_waits_for_the_wafer_slice():
    """The link half of screening, which the wafer slice brought: ``screen``
    with a router and ``screen_links`` find a dead link; a link blacklist
    reroutes a wafer experiment and, as in the reference, needs wafer
    mode (tests/test_torch_wafer_faults.py holds both to the
    reference)."""
    from repro_torch.wafer import InterChipRouter, s5_column_plan
    _, inst_t = _inst()
    core, ppu = AnnCore(CFG, inst_t), VectorUnit(CFG, inst_t)
    plan = s5_column_plan(4, R // 2, 16)
    fp = FaultPlan(dead_links=np.array([sd == (0, 2)
                                        for sd in plan.topology.links()]))
    router = InterChipRouter(plan, device="cpu", faults=fp)
    assert screen(core, ppu, router=router).links == ((0, 2),)
    assert screen_links(router) == ((0, 2),)
    assert screen(core, ppu).links == ()
    bl = Blacklist(rows=np.zeros(32, bool), neurons=np.zeros(16, bool),
                   links=((0, 2),))
    with pytest.raises(ValueError, match="link blacklists need wafer mode"):
        th.make_experiment(blacklist=bl, device="cpu")
    bl4 = Blacklist(rows=np.zeros((4, 32), bool),
                    neurons=np.zeros((4, 4), bool), links=((0, 2),))
    _, _, meta = th.make_experiment(blacklist=bl4, wafer=4, device="cpu")
    assert meta["router"].plan.n_forwards == 4


# ---------------------------------------------------------------------------
# Playback co-simulation under faults
# ---------------------------------------------------------------------------

def test_cosim_ref_models_same_faults():
    """tests/test_faults.py::TestInjection::test_cosim_ref_models_same_faults
    on the port: ``FastBackend`` and ``RefBackend`` give matching records
    for the same defect realisation, and the faults shaped the trace."""
    from repro_torch.verif import playback as pb
    rng = np.random.default_rng(2)
    fp = _covered_plan(rng)
    w = np.full((R, C), 50, np.int8)
    ev = np.zeros((120, R), np.float32)
    ev[10] = 1.0
    ev[60] = 1.0
    ev[100, ::2] = 1.0
    prog = [pb.write_weights(w), pb.inject(ev), pb.read_rates(),
            pb.read_corr(), pb.read_v(),
            pb.write_ppu_program(programs.rstdp_program(eta=8.0)),
            pb.ppu_run(mod=rng.uniform(-1, 1, (2, C)).astype(np.float32)),
            pb.read_weights()]
    tf = pb.execute(prog, "fast", CFG, device="cpu", faults=fp)
    tr = pb.execute(prog, "ref", CFG, faults=fp)
    errs = pb.compare_traces(tf, tr, atol=0.05)
    assert errs == [], "\n".join(errs)
    clean = pb.execute(prog, "fast", CFG, device="cpu")
    q_f = [v for _, k, v in tf if k == "CORR"][0]
    q_c = [v for _, k, v in clean if k == "CORR"][0]
    assert not np.array_equal(q_f, q_c)
