"""The network mapper in the port (``repro_torch.mapper``) against the
reference (``repro.mapper``), on the CPU.

- ``spec``, ``partition`` and ``mapping`` are copies (tier 1): the same
  specs from the same seeds, the same partitions, and over a seeded
  corpus (K in {1, 2, 3, 4}, Dale and mixed signs, ring and all2all,
  with and without a ``Blacklist``) every field of the port's
  ``ChipMapping`` equal to the reference's array for array, the plan's
  routes and forwards included; ``CapacityError`` raised at the same
  places with the same message. ``convert.mapping`` carries a reference
  mapping over unchanged.
- The hypothesis invariants (``ChipMapping.validate``) with
  ``min_chip_rows`` inside the ``CapacityError`` guard.
- ``scatter_instance``, ``place_inputs`` and ``gather_spikes`` exact
  against the reference, given the reference's spec-shaped ``net_inst``
  through ``convert.instance``.
- ``MappedRuntime.run`` (its window loop, ``wafer.router.WindowLoop``)
  against the reference's jitted run at 30-32 neurons (both on the
  fused backend, the reference's default): tier 2, window by window
  from the reference's state and routed grid, spikes equal up to flips
  where the membrane of the run that did not spike lies within
  rtol = atol = 1e-4 of threshold (``_torch_parity``); with no flip the
  free runs equal bit for bit.
- Inside the port, the reference's exactness contract: K in {1, 2, 4}
  equal to the monolithic K = 1 mapping (``assert_array_equal``) on the
  fused and blocked backends, ring and all2all, with a blacklist, and a
  network beyond one native chip; a relayed edge delivered one window
  late and counted in ``link_reroutes``; telemetry on and off bit-equal,
  the counters over W windows equal to the per-window counts summed.
"""
import jax
import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

from _torch_parity import assert_spikes_match, spike_threshold
from repro import mapper as jm
from repro.faults import Blacklist as JBlacklist
from repro_torch import convert, mapper
from repro_torch.faults import Blacklist, FaultPlan
from repro_torch.mapper.partition import CapacityError
from repro_torch.obs import trace as obs_trace

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYP = True
except ImportError:
    HAVE_HYP = False

CPU = torch.device("cpu")
MAPPING_ARRAYS = ("row_source", "row_sign", "row_addr", "weights",
                  "addresses")
PLAN_ARRAYS = convert._PLAN_ARRAYS


def _spec(pkg, seed=0, n_in=20, n_neurons=30, fan_out=4, rec_fan_out=3,
          dale=False, rec_mask=None):
    return pkg.random_spec(np.random.default_rng(seed), n_in, n_neurons,
                           fan_out=fan_out, rec_fan_out=rec_fan_out,
                           dale=dale, rec_mask=rec_mask)


def _ring_mask(n_neurons, quarters=(1, 3)):
    """tests/test_mapper.py::_ring_mask: recurrent edges only from quarter
    q to quarter (q+1) % 4, q in {1, 3}, so the net maps onto a ring
    without relays at K in {1, 2, 4}."""
    q = n_neurons // 4
    mask = np.zeros((n_neurons, n_neurons), bool)
    for src_q in quarters:
        dst_q = (src_q + 1) % 4
        mask[src_q * q:(src_q + 1) * q, dst_q * q:(dst_q + 1) * q] = True
    return mask


def _grid_spec(n_in, n_neurons):
    """tests/test_mapper.py::_grid_spec (the examples/map_network.py
    shape): input i excites neurons 2i and 2i+1, even neurons inhibit
    their successor."""
    w_in = np.zeros((n_in, n_neurons), np.int32)
    for i in range(n_in):
        w_in[i, (2 * i) % n_neurons] = 30
        w_in[i, (2 * i + 1) % n_neurons] = 20
    w_rec = np.zeros((n_neurons, n_neurons), np.int32)
    for j in range(0, n_neurons, 2):
        w_rec[j, (j + 1) % n_neurons] = -15
    return mapper.NetworkSpec(n_in, n_neurons, w_in, w_rec, name="grid")


def _inputs(n_in, rng, W=3, T=24, p=0.25):
    return (rng.random((W, T, n_in)) < p).astype(np.float32)


def _net_inst(spec, seed):
    """The port's own spec-shaped draw."""
    return mapper.sample_network_instance(
        spec, torch.Generator().manual_seed(seed), device=CPU)


def _mono_out(spec, net_inst, ev, backend="fused"):
    m1 = mapper.map_network(spec, 1, chip_rows=mapper.min_chip_rows(
        spec, 1, spec.n_neurons), chip_cols=spec.n_neurons)
    _, out = mapper.build_runtime(m1, net_inst=net_inst, backend=backend,
                                  device=CPU).run(ev)
    return out["spikes"].numpy()


def assert_mappings_equal(got, want):
    assert (got.n_chips, got.chip_rows, got.chip_cols) == (
        want.n_chips, want.chip_rows, want.chip_cols)
    assert_array_equal(got.spec.w_full(), want.spec.w_full())
    assert_array_equal(got.part.col_chip, want.part.col_chip)
    assert_array_equal(got.part.col_slot, want.part.col_slot)
    for k in MAPPING_ARRAYS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype, k
        assert_array_equal(a, b, err_msg=k)
    for k in PLAN_ARRAYS:
        assert_array_equal(getattr(got.plan, k), getattr(want.plan, k),
                           err_msg=k)
    assert got.plan.topology.links() == want.plan.topology.links()
    assert (got.n_relayed_edges, got.n_transit_rows) == (
        want.n_relayed_edges, want.n_transit_rows)
    assert got.input_rows() == want.input_rows()
    assert_array_equal(got.rows_used(), want.rows_used())


def _both(fn_t, fn_j):
    """Run the port's and the reference's call: both return equal-shaped
    results, or both raise ``CapacityError`` with the same message."""
    got = want = None
    try:
        got = fn_t()
    except CapacityError as e:
        got = ("CapacityError", str(e))
    try:
        want = fn_j()
    except jm.CapacityError as e:
        want = ("CapacityError", str(e))
    if isinstance(got, tuple) or isinstance(want, tuple):
        assert got == want
        return None, None
    return got, want


# ---------------------------------------------------------------------------
# The copies: spec, partition, mapping (tier 1)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dale", [True, False])
def test_random_spec_equal_to_reference(seed, dale):
    mask = _ring_mask(32) if seed == 2 else None
    got = _spec(mapper, seed, n_in=16, n_neurons=32, dale=dale,
                rec_mask=mask)
    want = _spec(jm, seed, n_in=16, n_neurons=32, dale=dale, rec_mask=mask)
    assert_array_equal(got.w_full(), want.w_full())
    assert_array_equal(got.dale_signs(), want.dale_signs())
    assert_array_equal(got.fan_in(), want.fan_in())
    assert_array_equal(got.fan_out(), want.fan_out())
    assert got.n_edges == want.n_edges and got.n_sources == want.n_sources


@pytest.mark.parametrize("args", [
    (1, 2, np.full((1, 2), 64), None),
    (1, 2, np.ones((1, 2), np.float32), None),
    (1, 2, np.ones((1, 2), np.int32), np.ones((1, 2), np.int32)),
    (2, 2, np.ones((1, 2), np.int32), None)])
def test_spec_validation_equal_to_reference(args):
    msgs = []
    for pkg in (mapper, jm):
        with pytest.raises(AssertionError) as e:
            pkg.NetworkSpec(*args)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and msgs[0]


@pytest.mark.parametrize("case", ["balanced", "shedding", "topup",
                                  "capacity"])
def test_partition_equal_to_reference(case):
    n, K, C, bad = {
        "balanced": (30, 4, 512, None),
        "shedding": (10, 2, 8, np.r_[[True] * 6, [False] * 10].reshape(2, 8)),
        "topup": (13, 3, 6, np.array([[0, 0, 0, 0, 0, 0],
                                      [1, 1, 1, 1, 1, 0],
                                      [0, 0, 0, 0, 0, 0]], bool)),
        "capacity": (17, 2, 8, None)}[case]
    got, want = _both(lambda: mapper.partition_columns(n, K, C, bad),
                      lambda: jm.partition_columns(n, K, C, bad))
    if case == "capacity":
        assert got is None
        return
    assert_array_equal(got.col_chip, want.col_chip)
    assert_array_equal(got.col_slot, want.col_slot)
    assert_array_equal(got.used_mask(), want.used_mask())
    for k in range(K):
        assert_array_equal(got.chip_neurons(k), want.chip_neurons(k))


def _blacklists(K, R, C, seed):
    """The same screened-out rows, neurons and (for K > 2) one dead link
    in both packages' ``Blacklist``."""
    rng = np.random.default_rng(100 + seed)
    rows = rng.random((K, R)) < 0.08
    neurons = rng.random((K, C)) < 0.1
    links = ((0, 1),) if K > 2 else ()     # K = 2 has no relay path
    return (Blacklist(rows=rows, neurons=neurons, links=links),
            JBlacklist(rows=rows, neurons=neurons, links=links))


@pytest.mark.parametrize("with_blacklist", [False, True])
@pytest.mark.parametrize("topology", ["all2all", "ring"])
@pytest.mark.parametrize("dale", [True, False])
@pytest.mark.parametrize("K", [1, 2, 3, 4])
def test_map_network_equal_to_reference(K, dale, topology, with_blacklist):
    """Every field of the mapping, array for array, over three seeds; the
    same ``CapacityError`` where the fabric is too small or a ring edge
    has no relay path. At least one seed of each case must map."""
    mapped = 0
    for seed in range(3):
        st_, sj = (_spec(p, seed, n_in=12, n_neurons=24, fan_out=3,
                         rec_fan_out=2, dale=dale) for p in (mapper, jm))
        C, R = -(-24 // K) + 4, 96
        bl_t = bl_j = None
        if with_blacklist:
            bl_t, bl_j = _blacklists(K, R, C, seed)
        got, want = _both(
            lambda: mapper.map_network(st_, K, chip_rows=R, chip_cols=C,
                                       topology=topology, blacklist=bl_t),
            lambda: jm.map_network(sj, K, chip_rows=R, chip_cols=C,
                                   topology=topology, blacklist=bl_j))
        if got is None:
            continue
        mapped += 1
        assert_mappings_equal(got, want)
        assert_array_equal(got.reconstruct(), want.reconstruct())
        assert_array_equal(mapper.row_demand(st_, got.part),
                           jm.row_demand(sj, want.part))
        assert mapper.min_chip_rows(st_, K, C, bl_t) == jm.min_chip_rows(
            sj, K, C, bl_j)
        if with_blacklist:
            assert not ((got.row_source >= 0) & bl_t.rows).any()
            assert not got.part.used_mask()[bl_t.neurons].any()
    assert mapped or (topology == "ring" and K >= 3)


@pytest.mark.parametrize("case", ["rows", "ring_no_relay", "columns"])
def test_capacity_errors_equal_to_reference(case):
    def args(pkg):
        if case == "rows":
            return (_spec(pkg, n_in=40, n_neurons=16, fan_out=8,
                          rec_fan_out=0), 1), dict(chip_rows=16,
                                                   chip_cols=16)
        if case == "columns":
            return (_spec(pkg), 2), dict(chip_rows=64, chip_cols=8)
        n = 16
        w_rec = np.zeros((n, n), np.int32)
        w_rec[0, 12] = 9           # chip 0 -> chip 3: distance 3 on K=4
        return (pkg.NetworkSpec(2, n, np.zeros((2, n), np.int32), w_rec),
                4), dict(chip_rows=8, chip_cols=4, topology="ring")
    (a_t, k_t), (a_j, k_j) = args(mapper), args(jm)
    msgs = []
    for pkg, a, k, err in ((mapper, a_t, k_t, CapacityError),
                           (jm, a_j, k_j, jm.CapacityError)):
        with pytest.raises(err) as e:
            pkg.map_network(*a, **k)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_ring_relay_equal_to_reference():
    """tests/test_mapper.py::test_ring_relay_inserts_forward_rules: one
    transit row and one forward rule, equal in both packages."""
    n = 16
    w_rec = np.zeros((n, n), np.int32)
    w_rec[0, 8] = 9
    m_t, m_j = (pkg.map_network(pkg.NetworkSpec(
        2, n, np.zeros((2, n), np.int32), w_rec), 4, chip_rows=8,
        chip_cols=4, topology="ring") for pkg in (mapper, jm))
    assert m_t.n_relayed_edges == 1 and m_t.plan.n_forwards == 1
    assert_mappings_equal(m_t, m_j)


def test_convert_mapping_round_trip():
    m_j = jm.map_network(_spec(jm), 3, chip_rows=96, chip_cols=12,
                         blacklist=_blacklists(3, 96, 12, 0)[1])
    got = convert.mapping(m_j)
    assert isinstance(got, mapper.ChipMapping) and got.n_relayed_edges
    assert_mappings_equal(got, m_j)
    assert_mappings_equal(got, mapper.map_network(
        _spec(mapper), 3, chip_rows=96, chip_cols=12,
        blacklist=_blacklists(3, 96, 12, 0)[0]))


if HAVE_HYP:
    @settings(max_examples=25, deadline=None)
    @given(seed=st.integers(0, 2**31 - 1), n_in=st.integers(1, 24),
           n_neurons=st.integers(4, 40), k=st.sampled_from([1, 2, 3, 4]),
           dale=st.booleans())
    def test_mapping_invariants_hypothesis(seed, n_in, n_neurons, k, dale):
        """tests/test_mapper.py::TestMapping::test_mapping_invariants_
        hypothesis, with its defect repaired: the reference test calls
        ``min_chip_rows`` outside its ``CapacityError`` guard, so a spec
        whose neurons do not fit the columns (``n_neurons=17, k=1`` on 16
        columns) raises there (``partition_columns``) and fails the
        test, though the mapper is right to refuse. Here the sizing is
        inside the guard. The reference maps each example too: the same
        mapping, or the same refusal."""
        st_, sj = (_spec(p, seed, n_in=n_in, n_neurons=n_neurons,
                         fan_out=3, rec_fan_out=2, dale=dale)
                   for p in (mapper, jm))

        def port():
            rows = mapper.min_chip_rows(st_, k, 16) + 8   # transit slack
            return mapper.map_network(st_, k, chip_rows=rows, chip_cols=16)

        def ref():
            rows = jm.min_chip_rows(sj, k, 16) + 8
            return jm.map_network(sj, k, chip_rows=rows, chip_cols=16)
        got, want = _both(port, ref)
        if got is None:
            return            # undersized fabric: rejected, not mangled
        got.validate()        # plan validity, addr uniqueness, Dale
        #                       parity, FMA order, exact reconstruction
        assert_mappings_equal(got, want)
else:
    @pytest.mark.skip(reason="hypothesis not installed")
    def test_mapping_invariants_hypothesis():
        pass


# ---------------------------------------------------------------------------
# Runtime pieces against the reference (tier 1)
# ---------------------------------------------------------------------------

def _ref_case(K=2, seed=3, **kw):
    """A mapped spec in both packages, the reference's net_inst and the
    port's copy of it."""
    sj = _spec(jm, **kw)
    rows = jm.min_chip_rows(sj, K, -(-sj.n_neurons // K) + 2) + 8
    m_j = jm.map_network(sj, K, chip_rows=rows,
                         chip_cols=-(-sj.n_neurons // K) + 2)
    m_t = convert.mapping(m_j)
    ni_j = jax.tree.map(np.asarray, jm.sample_network_instance(
        sj, jax.random.PRNGKey(seed)))
    return m_j, m_t, ni_j, convert.instance(ni_j, device=CPU)


def test_sample_network_instance_shapes():
    spec = _spec(mapper)
    a = _net_inst(spec, 3)
    b = _net_inst(spec, 3)
    assert a["weight_gain"].shape == (spec.n_neurons,)
    assert a["stp_offset"].shape == (spec.n_sources,)
    for k in a["neuron_params"]:
        assert a["neuron_params"][k].shape == (spec.n_neurons,)
        assert torch.equal(a["neuron_params"][k], b["neuron_params"][k])


@pytest.mark.parametrize("K", [1, 2, 4])
def test_scatter_instance_equal_to_reference(K):
    from repro.configs.bss2 import BSS2 as J_BSS2
    from repro_torch.configs.bss2 import BSS2
    m_j, m_t, ni_j, ni_t = _ref_case(K)
    want = jax.tree.map(np.asarray, jm.scatter_instance(
        m_j, ni_j, J_BSS2.reduced()))
    got = convert.to_numpy(mapper.scatter_instance(m_t, ni_t,
                                                   BSS2.reduced()))
    assert set(got) == set(want)
    for k in want:
        if k == "neuron_params":
            for n in want[k]:
                assert_array_equal(got[k][n], want[k][n], err_msg=n)
        else:
            assert got[k].dtype == want[k].dtype, k
            assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("K", [1, 2, 4])
def test_place_inputs_and_gather_spikes_equal_to_reference(K):
    m_j, m_t, _, _ = _ref_case(K)
    rng = np.random.default_rng(K)
    ev = _inputs(m_t.spec.n_in, rng)
    ev_j, ad_j = jm.place_inputs(m_j, ev)
    ev_t, ad_t = mapper.place_inputs(m_t, torch.from_numpy(ev))
    assert ev_t.dtype == torch.float32 and ad_t.dtype == torch.int8
    assert_array_equal(ev_t.numpy(), np.asarray(ev_j))
    assert_array_equal(ad_t.numpy(), np.asarray(ad_j))
    sp = (rng.random((3, 24, K, m_t.chip_cols)) < 0.3).astype(np.float32)
    want = np.asarray(jm.gather_spikes(m_j, sp))
    assert_array_equal(mapper.gather_spikes(m_t, torch.from_numpy(sp))
                       .numpy(), want)
    rt = mapper.build_runtime(m_t, device=CPU)
    assert_array_equal(rt.gather(torch.from_numpy(sp)).numpy(), want)
    ev_r, ad_r = rt.place(torch.from_numpy(ev))
    assert torch.equal(ev_r, ev_t) and torch.equal(ad_r, ad_t)


@pytest.mark.parametrize("case", ["all2all_k2", "all2all_k4", "ring_k2"])
def test_run_equal_to_reference(case):
    """Tier 2: each window of the port's run from the reference's state
    and routed grid (teacher-forced), spikes equal up to flips at
    threshold, the routed grid equal wherever the spikes are; the free
    runs bit-equal when no window flipped."""
    K = 4 if case.endswith("k4") else 2
    topo = "ring" if case.startswith("ring") else "all2all"
    kw = dict(n_in=16, n_neurons=32, rec_mask=_ring_mask(32)) \
        if topo == "ring" else {}
    sj = _spec(jm, rec_fan_out=3, **kw)
    C = -(-sj.n_neurons // K) + (0 if topo == "ring" else 2)
    m_j = jm.map_network(sj, K, chip_rows=jm.min_chip_rows(sj, K, C) + 8,
                         chip_cols=C, topology=topo)
    m_t = convert.mapping(m_j)
    ni_j = jax.tree.map(np.asarray, jm.sample_network_instance(
        sj, jax.random.PRNGKey(5)))
    rt_j = jm.build_runtime(m_j, net_inst=ni_j, backend="fused")
    rt_t = mapper.build_runtime(m_t, net_inst=convert.instance(ni_j, CPU),
                                backend="fused", device=CPU)
    ev = _inputs(sj.n_in, np.random.default_rng(11))
    ev_j, ad_j = jm.place_inputs(m_j, ev)
    ev_t, ad_t = rt_t.place(torch.from_numpy(ev))
    thr = spike_threshold(convert.to_numpy(rt_t.inst["neuron_params"]),
                          adex=rt_t.chip_cfg.neuron.adex)
    st_j, routed_j = rt_j.init_state(), rt_j.router.init_buffer(24)
    flips = 0
    for w in range(ev.shape[0]):
        st_t = convert.core_state(jax.tree.map(np.asarray, st_j), CPU)
        routed_t = torch.from_numpy(np.array(routed_j))
        st_j, out_j = rt_j.core.run_routed(st_j, routed_j, ev_j[w], ad_j[w],
                                           rt_j.router, record_v=True)
        _, out_t = rt_t.core.run_routed(st_t, routed_t, ev_t[w], ad_t[w],
                                        rt_t.router, record_v=True)
        s_j, s_t = np.asarray(out_j["spikes"]), out_t["spikes"].numpy()
        assert_spikes_match(s_t, s_j, out_t["v"].numpy(),
                            np.asarray(out_j["v"]), thr)
        flips += int((s_t != s_j).sum())
        if (s_t == s_j).all():
            assert_array_equal(out_t["routed"].numpy(),
                               np.asarray(out_j["routed"]))
        routed_j = out_j["routed"]
    _, free_j = rt_j.run(ev)
    _, free_t = rt_t.run(torch.from_numpy(ev))
    assert list(rt_t.loops) == [(3, 24, False)]     # the window loop ran
    assert np.asarray(free_j["spikes"]).sum() > 0
    if flips == 0:
        assert_array_equal(free_t["spikes"].numpy(),
                           np.asarray(free_j["spikes"]))
        assert_array_equal(free_t["chip_spikes"].numpy(),
                           np.asarray(free_j["chip_spikes"]))


# ---------------------------------------------------------------------------
# Inside the port: the exactness contract (tests/test_mapper.py::
# TestExactness), bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["fused", "blocked"])
@pytest.mark.parametrize("k", [2, 4])
def test_all2all_round_trip(k, backend):
    spec = _spec(mapper, rec_fan_out=3)
    ev = _inputs(spec.n_in, np.random.default_rng(1))
    net_inst = _net_inst(spec, 3)
    mono = _mono_out(spec, net_inst, ev, backend=backend)
    cols = 30 // k + 2
    rows = mapper.min_chip_rows(spec, k, cols) + 8
    m = mapper.map_network(spec, k, chip_rows=rows, chip_cols=cols)
    _, out = mapper.build_runtime(m, net_inst=net_inst, backend=backend,
                                  device=CPU).run(ev)
    assert mono.sum() > 0, "a silent network proves nothing"
    assert_array_equal(out["spikes"].numpy(), mono)


@pytest.mark.parametrize("backend", ["fused", "blocked"])
@pytest.mark.parametrize("k", [2, 4])
def test_ring_round_trip(k, backend):
    spec = _spec(mapper, n_in=16, n_neurons=32, rec_fan_out=3,
                 rec_mask=_ring_mask(32))
    ev = _inputs(spec.n_in, np.random.default_rng(2))
    net_inst = _net_inst(spec, 5)
    mono = _mono_out(spec, net_inst, ev, backend=backend)
    m = mapper.map_network(spec, k, chip_rows=64, chip_cols=32 // k,
                           topology="ring")
    assert m.plan.n_forwards == 0, "ring-realizable: no relays"
    _, out = mapper.build_runtime(m, net_inst=net_inst, backend=backend,
                                  device=CPU).run(ev)
    assert mono.sum() > 0, "a silent network proves nothing"
    assert_array_equal(out["spikes"].numpy(), mono)


@pytest.mark.parametrize("backend", ["fused", "blocked"])
def test_blacklist_round_trip(backend):
    """Placement avoids the screened-out fabric, so the mapped network
    equals the clean monolithic one, with the blacklisted resources
    killed by faults."""
    spec = _spec(mapper, rec_fan_out=3)
    ev = _inputs(spec.n_in, np.random.default_rng(3))
    net_inst = _net_inst(spec, 3)
    mono = _mono_out(spec, net_inst, ev, backend=backend)
    K, R, C = 4, 64, 12
    rows = np.zeros((K, R), bool)
    rows[0, :16] = rows[2, 1::4] = True
    neurons = np.zeros((K, C), bool)
    neurons[1, :3] = neurons[3, -2:] = True
    m = mapper.map_network(spec, K, chip_rows=R, chip_cols=C,
                           blacklist=Blacklist(rows=rows, neurons=neurons))
    faults = FaultPlan(dead_rows=rows, dead_neurons=neurons)
    _, out = mapper.build_runtime(m, net_inst=net_inst, faults=faults,
                                  backend=backend, device=CPU).run(ev)
    assert mono.sum() > 0, "a silent network proves nothing"
    assert_array_equal(out["spikes"].numpy(), mono)


def test_oversize_network_beyond_native_fabric():
    """300 inputs x 700 neurons on 4 native 256 x 512 chips equals the
    (virtual) big-chip emulation."""
    spec = _grid_spec(300, 700)
    ev = _inputs(300, np.random.default_rng(4), W=2, T=16, p=0.05)
    net_inst = _net_inst(spec, 9)
    mono = _mono_out(spec, net_inst, ev)
    m = mapper.map_network(spec, 4, chip_rows=256, chip_cols=512)
    _, out = mapper.build_runtime(m, net_inst=net_inst, device=CPU).run(ev)
    assert mono.sum() > 0, "a silent network proves nothing"
    assert_array_equal(out["spikes"].numpy(), mono)


def _relay_spec():
    """tests/test_mapper.py::TestRelayExecution's network: neuron 0 (chip
    0) drives neuron 8 (chip 2) on a K = 4 ring, one relay on chip 1."""
    n = 16
    w_rec = np.zeros((n, n), np.int32)
    w_rec[0, 8] = 40
    w_in = np.zeros((2, n), np.int32)
    w_in[0, 0] = 50
    return w_in, w_rec


def test_relayed_edge_delivered_one_window_late():
    """The relayed edge reaches chip 2 one window after a direct link
    would: window 0's spikes of neuron 0 land on the transit row of chip
    1 in window 1's input, and on neuron 8's row of chip 2 in window 2's;
    the forwarded events are counted in ``link_reroutes``, equal to the
    reference's count."""
    w_in, w_rec = _relay_spec()
    m = mapper.map_network(mapper.NetworkSpec(2, 16, w_in, w_rec), 4,
                           chip_rows=8, chip_cols=4, topology="ring")
    assert m.plan.n_forwards == 1
    tc, tr = int(m.plan.fwd_src_chip[0]), int(m.plan.fwd_src_row[0])
    dc, dr = int(m.plan.fwd_dst_chip[0]), int(m.plan.fwd_dst_row[0])
    assert (tc, dc) == (1, 2)
    rt = mapper.build_runtime(m, telemetry=True, device=CPU)
    ev = np.zeros((4, 16, 2), np.float32)
    ev[0, :, 0] = 1.0          # drive input 0 hard in window 0
    ev_t, ad_t = rt.place(torch.from_numpy(ev))
    st, routed = rt.init_state(), rt.router.init_buffer(16)
    grids, spikes = [], []
    for w in range(3):
        st, out = rt.core.run_routed(st, routed, ev_t[w], ad_t[w],
                                     rt.router)
        routed = out["routed"]
        grids.append(routed)
        spikes.append(out["spikes"])
    s0 = spikes[0][:, 0, int(m.part.col_slot[0])]
    assert s0.sum() > 0, "neuron 0 must fire in window 0"
    assert torch.equal(grids[0][:, tc, tr], s0)     # relay row, window 1
    assert grids[0][:, dc, dr].sum() == 0           # no direct delivery
    assert torch.equal(grids[1][:, dc, dr], s0)     # destination, window 2
    _, out = rt.run(ev)
    tele = obs_trace.summary(out["telemetry"])
    assert tele["link_reroutes"] > 0, "forward traffic must be counted"
    m_j = jm.map_network(jm.NetworkSpec(2, 16, w_in, w_rec), 4,
                         chip_rows=8, chip_cols=4, topology="ring")
    from repro.obs import trace as j_trace
    ni_j = jax.tree.map(np.asarray, jm.sample_network_instance(
        m_j.spec, jax.random.PRNGKey(1)))
    rt_j = jm.build_runtime(m_j, net_inst=ni_j, telemetry=True)
    _, out_j = rt_j.run(ev, telemetry=j_trace.init_telemetry())
    rt_t = mapper.build_runtime(m, net_inst=convert.instance(ni_j, CPU),
                                telemetry=True, device=CPU)
    _, out_t = rt_t.run(ev)
    assert_array_equal(out_t["spikes"].numpy(), np.asarray(out_j["spikes"]))
    assert obs_trace.summary(out_t["telemetry"])["link_reroutes"] == int(
        j_trace.summary(out_j["telemetry"])["link_reroutes"])


SUMMED = ("steps", "in_events", "out_spikes", "dense_windows",
          "sparse_windows", "gated_windows", "overflow_fallbacks",
          "routed_events", "link_overflows", "link_reroutes")
MAXED = ("census_events_max", "census_k_max", "link_events_max")


@pytest.mark.parametrize("backend", ["fused", "blocked"])
def test_telemetry_on_off_and_over_windows(backend):
    """``build_runtime(telemetry=True)``: spikes bit-equal to off; the
    counters ``run`` returns span all W windows: each additive counter is
    the sum, each worst-case counter the maximum, of the counts of the
    windows run one by one with fresh counters."""
    rng = np.random.default_rng(3)
    spec = mapper.random_spec(rng, 8, 16, fan_out=3, rec_fan_out=2,
                              dale=True)
    m = mapper.map_network(spec, 2, chip_rows=64, chip_cols=8)
    ev = (rng.random((3, 16, 8)) < 0.2).astype(np.float32)
    rt_on = mapper.build_runtime(m, telemetry=True, backend=backend,
                                 device=CPU)
    _, out_on = rt_on.run(ev)
    rt_off = mapper.build_runtime(m, net_inst=rt_on.net_inst,
                                  backend=backend, device=CPU)
    _, out_off = rt_off.run(ev)
    assert out_off["telemetry"] is None
    assert torch.equal(out_on["spikes"], out_off["spikes"])
    total = obs_trace.summary(out_on["telemetry"])
    assert total["in_events"] > 0 and total["routed_events"] > 0
    ev_t, ad_t = rt_on.place(torch.from_numpy(ev))
    st, routed = rt_on.init_state(), rt_on.router.init_buffer(16)
    per = []
    for w in range(3):
        st, out = rt_on.core.run_routed(
            st, routed, ev_t[w], ad_t[w], rt_on.router,
            telemetry=obs_trace.init_telemetry(CPU))
        routed = out["routed"]
        per.append(obs_trace.summary(out["telemetry"]))
    for k in SUMMED:
        assert total[k] == sum(p[k] for p in per), k
    for k in MAXED:
        assert total[k] == max(p[k] for p in per), k
    assert total["steps"] == 3 * 16


def test_build_runtime_needs_a_device_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None means cuda")
    spec = _spec(mapper)
    m = mapper.map_network(spec, 2, chip_rows=mapper.min_chip_rows(
        spec, 2, 17) + 8, chip_cols=17)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mapper.build_runtime(m)
    # faults with a group are taken (tests/test_torch_wafer_sharded.py
    # holds them to the local transport): each rank's core gets its
    # chips' planes, the router every link
    from repro_torch.faults import slice_chips
    rows = np.zeros((2, m.chip_rows), bool)
    rows[1, 3] = True
    links = np.ones(len(m.plan.topology.links()), bool)
    cut = slice_chips(FaultPlan(dead_rows=rows, dead_links=links),
                      slice(1, 2))
    assert cut.dead_rows.shape == (1, m.chip_rows) and cut.dead_rows[0, 3]
    assert np.array_equal(cut.dead_links, links)
