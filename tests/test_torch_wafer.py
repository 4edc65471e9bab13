"""The wafer in the port (``repro_torch.wafer``) against the reference
(``repro.wafer``), at the reference's own test geometry (R, C, T, W = 16,
8, 32, 3; tests/test_wafer.py).

- The topology module is a copy: links, validation errors, monolithic
  embeddings, the §5 split, relay rows, address grids and reroutes with
  their forward rules equal to the reference's (tier 1), and
  ``convert.plan`` carries a reference plan over unchanged.
- ``InterChipRouter.route``: the delivered grid and the link counters
  equal the reference's bit for bit in every mode, with the link budget
  and the step budget over and under the census (the compact transport's
  drops included); ``events.stream_keep`` is the reference's
  pack -> truncate -> unpack keep rule.
- ``run_windows``: spikes equal to the reference's on the CPU, ring and
  all2all (both run the fused backend on the same instance); inside the
  port split == monolithic bit for bit on the fused and blocked backends,
  and the link-budget contract of tests/test_wafer.py::TestLinkBudget.
- ``run_training(wafer=K)`` for K in 1, 2, 4 with the reference's
  instance and draws injected, 8 trials at 32 x 16 (T = 128): rewards,
  6-bit weights and link counters exact, the signed weights within
  rtol = atol = 1e-4. Every window of that geometry is below the
  sparse route's work floor, so every window takes the dense route
  (const-address form) in both packages. Inside the port, chip-count
  parity bit for bit, K = 1 without relays equal to the plain
  experiment, and the run's three modes bit-equal in wafer mode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close
from repro.configs.bss2 import BSS2 as J_BSS2
from repro.core import events as j_events
from repro.core import hybrid as jh
from repro.core.anncore import AnnCore as JAnnCore
from repro.obs import trace as j_trace
from repro.verif.mismatch import sample_instance as j_sample_instance
from repro import wafer as jw
from repro_torch import convert
from repro_torch.configs.bss2 import BSS2
from repro_torch.core import events, synapse
from repro_torch.core import hybrid as th
from repro_torch.core.anncore import AnnCore
from repro_torch.obs import trace as obs_trace
from repro_torch import wafer as tw

R, C, T, W = 16, 8, 32, 3
ADDR = 7
CFG = dataclasses.replace(BSS2.reduced(), n_rows=R, n_cols=C)
CFG_J = dataclasses.replace(J_BSS2.reduced(), n_rows=R, n_cols=C)
COUNTERS = ("routed_events", "link_overflows", "link_events_max",
            "link_reroutes")


def random_routes(K, kind, rng, per_link=4):
    """tests/test_wafer.py::_random_plan's routes (address 7)."""
    routes = []
    for s in range(K):
        for d in ([(s + 1) % K] if kind == "ring" else range(K)):
            for _ in range(per_link):
                routes.append((s, int(rng.integers(C)), d,
                               int(rng.integers(R)), ADDR))
    return routes


def plans(K, kind, seed=0):
    """The same random plan in both packages."""
    routes = random_routes(K, kind, np.random.default_rng(seed))
    return (jw.make_plan(jw.WaferTopology(K, kind), R, C, routes),
            tw.make_plan(tw.WaferTopology(K, kind), R, C, routes))


def chip_arrays(plan, rng):
    """tests/test_wafer.py::_chip_arrays: weights, and relay rows storing
    address 7 so that routed events conduct."""
    K = plan.topology.n_chips
    w = rng.integers(20, 60, (K, R, C)).astype(np.int8)
    a = np.zeros((K, R, C), np.int8)
    relay = plan.relay_rows()
    for k in range(K):
        a[k][relay[k]] = ADDR
    return w, a


def window_inputs(K, rng, p=0.3):
    ev = (rng.random((W, T, K, R)) < p).astype(np.float32)
    return ev, np.zeros((W, T, K, R), np.int8)


def summary_counts(tele):
    s = obs_trace.summary(tele)
    return {k: s[k] for k in COUNTERS}


def j_summary_counts(tele):
    s = j_trace.summary(tele)
    return {k: int(s[k]) for k in COUNTERS}


def assert_plans_equal(got, want):
    assert got.topology.links() == want.topology.links()
    assert (got.n_rows, got.n_cols) == (want.n_rows, want.n_cols)
    for k in convert._PLAN_ARRAYS:
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
    np.testing.assert_array_equal(got.relay_rows(), want.relay_rows())
    np.testing.assert_array_equal(got.dst_addr_grid(), want.dst_addr_grid())


# ---------------------------------------------------------------------------
# Topology: a copy of the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K", [1, 2, 3, 4])
@pytest.mark.parametrize("kind", ["ring", "all2all"])
def test_links_equal_to_reference(K, kind):
    got, want = tw.WaferTopology(K, kind), jw.WaferTopology(K, kind)
    assert got.links() == want.links()
    assert (got.n_links, got.links_per_chip) == (want.n_links,
                                                 want.links_per_chip)


@pytest.mark.parametrize("routes,match", [
    ([(0, 0, 0, 0, 1)], "non-links"),
    ([(0, 0, 1, 0, 64)], "6-bit"),
    ([(0, 0, 1, 3, 1), (0, 1, 1, 3, 2)], "conflicting"),
])
def test_plan_validation_equal_to_reference(routes, match):
    for mod in (jw, tw):
        with pytest.raises(AssertionError, match=match):
            mod.make_plan(mod.WaferTopology(2, "ring"), R, C, routes)


@pytest.mark.parametrize("kind,K", [("ring", 2), ("all2all", 4)])
def test_monolithic_equal_to_reference(kind, K):
    j_plan, t_plan = plans(K, kind)
    assert_plans_equal(tw.monolithic_plan(t_plan),
                       jw.monolithic_plan(j_plan))
    w = np.random.default_rng(1).integers(0, 63, (K, R, C)).astype(np.int8)
    np.testing.assert_array_equal(tw.monolithic_weights(w),
                                  jw.monolithic_weights(w))


@pytest.mark.parametrize("K,relay", [(1, False), (1, True), (2, True),
                                     (4, True)])
def test_s5_column_plan_equal_to_reference(K, relay):
    assert_plans_equal(tw.s5_column_plan(K, 8, 16, relay=relay),
                       jw.s5_column_plan(K, 8, 16, relay=relay))


@pytest.mark.parametrize("case", ["s5_one", "s5_two", "a2a_random",
                                  "ring_promotion", "not_on_a_route"])
def test_reroute_plan_equal_to_reference(case):
    """The failover plans, forward rules included, and the re-homed route
    counts; a ring with no detour is promoted to all2all."""
    if case.startswith("s5"):
        ref = jw.s5_column_plan(4, 8, 16)
        dead = [(0, 2)] if case == "s5_one" else [(0, 2), (3, 1)]
    elif case == "a2a_random":
        ref = plans(4, "all2all", seed=3)[0]
        dead = [(1, 3)]
    elif case == "ring_promotion":
        ref = jw.make_plan(jw.WaferTopology(3, "ring"), 4, 2,
                           [(0, 0, 1, 0, 7), (1, 1, 2, 1, 9),
                            (2, 0, 0, 2, 11)])
        dead = [(1, 2)]
    else:
        ref = jw.s5_column_plan(2, 8, 16, relay=False)
        dead = [(0, 1)]
    want, n_want = jw.reroute_plan(ref, dead)
    got, n_got = tw.reroute_plan(convert.plan(ref), dead)
    assert n_got == n_want
    assert_plans_equal(got, want)
    if case == "ring_promotion":
        assert got.topology.kind == "all2all" and got.n_forwards == 1


def test_reroute_raises_when_impossible():
    routes = [(0, 0, 1, 0, 7)]
    for mod in (jw, tw):
        plan = mod.make_plan(mod.WaferTopology(2, "all2all"), 4, 2, routes)
        with pytest.raises(ValueError, match="no failover"):
            mod.reroute_plan(plan, [(0, 1)])


def test_convert_plan_round_trip():
    ref = jw.reroute_plan(jw.s5_column_plan(4, 8, 16), [(0, 2)])[0]
    assert_plans_equal(convert.plan(ref), ref)


# ---------------------------------------------------------------------------
# The router, one window: delivered grids and counters tier 1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_events,budget,step_budget", [
    (40, 1000, 16), (40, 7, 16), (40, 1000, 2), (40, 9, 1), (0, 4, 2),
    (512, 100, 5)])
def test_stream_keep_is_the_reference_pack_truncate_unpack(n_events, budget,
                                                           step_budget):
    """The compact link transport's keep rule against the reference's
    ``pack_events_batch`` -> ``truncate_stream`` -> ``unpack_events_batch``
    on grids over and under both budgets."""
    rng = np.random.default_rng(n_events + budget + step_budget)
    grids = np.zeros((3, T * R), np.float32)
    for b in range(3):
        grids[b, rng.choice(T * R, n_events, replace=False)] = \
            rng.uniform(0.1, 1.0, n_events)
    grids = grids.reshape(3, T, R)
    st = j_events.pack_events_batch(jnp.asarray(grids),
                                    jnp.zeros(grids.shape, jnp.int32),
                                    budget)
    if step_budget < R:
        st = j_events.truncate_stream(st, T, step_budget)
    want = np.asarray(j_events.unpack_events_batch(st, T, R)[0])
    keep, _ = events.stream_keep(torch.from_numpy(grids) != 0.0, budget,
                                 step_budget)
    got = torch.from_numpy(grids).masked_fill(~keep, 0.0).numpy()
    np.testing.assert_array_equal(got, want)


def _route_both(kind, K, mode, budget=None, step_budget=None, p=0.4,
                seed=5):
    j_plan, t_plan = plans(K, kind)
    sp = (np.random.default_rng(seed).random((T, K, C)) < p
          ).astype(np.float32)
    jr = jw.InterChipRouter(j_plan, link_budget=budget,
                            link_step_budget=step_budget, link_mode=mode)
    tr = tw.InterChipRouter(t_plan, device="cpu", link_budget=budget,
                            link_step_budget=step_budget, link_mode=mode)
    jg, jt = jax.jit(jr.route)(jnp.asarray(sp), j_trace.init_telemetry())
    tg, tt = tr.route(torch.from_numpy(sp), obs_trace.init_telemetry("cpu"))
    return (np.asarray(jg), j_summary_counts(jt)), (tg.numpy(),
                                                    summary_counts(tt))


@pytest.mark.parametrize("budget,step_budget", [
    (None, None), (4, None), (None, 1), (12, 2)])
@pytest.mark.parametrize("mode", ["dense", "compact", "auto"])
@pytest.mark.parametrize("kind,K", [("ring", 2), ("ring", 4),
                                    ("all2all", 4)])
def test_route_equal_to_reference(kind, K, mode, budget, step_budget):
    """The next window's delivery grid and the link counters, bit for bit,
    within the budgets and over them (compact drops records there)."""
    (jg, jc), (tg, tc) = _route_both(kind, K, mode, budget, step_budget)
    np.testing.assert_array_equal(tg, jg)
    assert tc == jc
    assert jc["routed_events"] > 0
    if budget is not None or step_budget is not None:
        assert jc["link_overflows"] > 0


def test_auto_is_dense_and_compact_drops_over_budget():
    """Auto delivers the grids whether the links fit or not; compact over
    budget drops records, and the counters say so."""
    (_, _), (dense, c_dense) = _route_both("all2all", 4, "dense", p=0.1)
    assert c_dense["link_overflows"] == 0
    for budget in (None, 4):
        (_, _), (auto, c_auto) = _route_both("all2all", 4, "auto", budget,
                                             p=0.1)
        np.testing.assert_array_equal(auto, dense)
        assert (c_auto["link_overflows"] > 0) == (budget is not None)
    (_, _), (tiny, c_tiny) = _route_both("all2all", 4, "compact", 4, p=0.1)
    assert tiny.sum() < dense.sum()
    assert c_tiny["link_overflows"] > 0


def test_merge_equal_to_reference():
    j_plan, t_plan = plans(4, "all2all")
    rng = np.random.default_rng(2)
    routed = (rng.random((T, 4, R)) < 0.3).astype(np.float32)
    ext = (rng.random((T, 4, R)) < 0.3).astype(np.float32)
    ext_a = rng.integers(0, 64, (T, 4, R)).astype(np.int8)
    je, ja = jw.InterChipRouter(j_plan).merge(
        jnp.asarray(routed), jnp.asarray(ext), jnp.asarray(ext_a))
    te, ta = tw.InterChipRouter(t_plan, device="cpu").merge(
        torch.from_numpy(routed), torch.from_numpy(ext),
        torch.from_numpy(ext_a))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert ta.dtype == torch.int8


# ---------------------------------------------------------------------------
# run_windows: the routed emulation
# ---------------------------------------------------------------------------

def _j_run(core, router, prefix, w, a, ev, ad):
    st = core.init_state(prefix)
    st = st._replace(syn=st.syn._replace(weights=jnp.asarray(w),
                                         addresses=jnp.asarray(a)))
    _, out = jax.jit(lambda s, e, d: jw.run_windows(
        core, router, s, e, d, telemetry=j_trace.init_telemetry()))(
            st, jnp.asarray(ev), jnp.asarray(ad))
    return out


def _t_run(core, router, prefix, w, a, ev, ad):
    st = core.init_state(prefix)
    st = st._replace(syn=st.syn._replace(weights=torch.from_numpy(w),
                                         addresses=torch.from_numpy(a)))
    _, out = tw.run_windows(core, router, st, torch.from_numpy(ev),
                            torch.from_numpy(ad),
                            telemetry=obs_trace.init_telemetry("cpu"))
    return out


def _split_cores(K, backend="fused"):
    inst = jax.tree.map(np.asarray, j_sample_instance(
        CFG_J, jax.random.PRNGKey(3), (K,)))
    return (JAnnCore(CFG_J, inst, backend=backend),
            AnnCore(CFG, convert.instance(inst, "cpu"), backend=backend),
            inst)


@pytest.mark.parametrize("kind,K", [("ring", 2), ("all2all", 4)])
def test_run_windows_equal_to_reference(kind, K):
    """Spikes of W routed windows equal the reference's, and the link
    counters too (the reference's fused backend on the same instance)."""
    rng = np.random.default_rng(1)
    j_plan, t_plan = plans(K, kind)
    w, a = chip_arrays(t_plan, rng)
    ev, ad = window_inputs(K, rng)
    j_core, t_core, _ = _split_cores(K)
    jo = _j_run(j_core, jw.InterChipRouter(j_plan), (K,), w, a, ev, ad)
    to = _t_run(t_core, tw.InterChipRouter(t_plan, device="cpu"), (K,), w,
                a, ev, ad)
    assert np.asarray(jo["spikes"]).sum() > 0
    np.testing.assert_array_equal(to["spikes"].numpy(),
                                  np.asarray(jo["spikes"]))
    np.testing.assert_array_equal(to["routed"].numpy(),
                                  np.asarray(jo["routed"]))
    assert summary_counts(to["telemetry"]) == j_summary_counts(
        jo["telemetry"])
    assert summary_counts(to["telemetry"])["routed_events"] > 0


def _mono_core(inst, K, backend):
    """The same instance as ONE chip, columns chip-block-contiguous and
    rows per chip (tests/test_wafer.py::_mono_core)."""
    minst = {k: v.reshape(1, -1) for k, v in inst.items()
             if k != "neuron_params"}
    minst["neuron_params"] = {k: v.reshape(1, -1) for k, v in
                              inst["neuron_params"].items()}
    mcfg = dataclasses.replace(CFG, n_rows=K * R, n_cols=K * C)
    return AnnCore(mcfg, minst, backend=backend)


@pytest.mark.parametrize("backend", ["fused", "blocked"])
@pytest.mark.parametrize("kind,K", [("ring", 2), ("all2all", 4)])
def test_split_equals_monolithic(kind, K, backend):
    """K chips and the router == one big chip with block-diagonal weights
    and the same routes in global coordinates, bit for bit."""
    rng = np.random.default_rng(1)
    _, plan = plans(K, kind)
    w, a = chip_arrays(plan, rng)
    ev, ad = window_inputs(K, rng)
    inst = convert.instance(jax.tree.map(np.asarray, j_sample_instance(
        CFG_J, jax.random.PRNGKey(3), (K,))), "cpu")
    core = AnnCore(CFG, inst, backend=backend)
    out = _t_run(core, tw.InterChipRouter(plan, device="cpu"), (K,), w, a,
                 ev, ad)
    spikes = out["spikes"].numpy()
    assert spikes.sum() > 0
    assert summary_counts(out["telemetry"])["routed_events"] > 0
    mout = _t_run(_mono_core(inst, K, backend),
                  tw.InterChipRouter(tw.monolithic_plan(plan), device="cpu"),
                  (1,), tw.monolithic_weights(w)[None],
                  tw.monolithic_weights(a)[None],
                  ev.reshape(W, T, 1, K * R), ad.reshape(W, T, 1, K * R))
    np.testing.assert_array_equal(
        spikes, mout["spikes"].numpy().reshape(W, T, K, C))


class TestLinkBudget:
    """tests/test_wafer.py::TestLinkBudget in the port: auto delivers
    bit-exactly and counts, forced compact over budget diverges and
    counts."""

    def _runs(self, **router_kw):
        rng = np.random.default_rng(1)
        _, plan = plans(4, "all2all")
        w, a = chip_arrays(plan, rng)
        ev, ad = window_inputs(4, rng)
        _, core, _ = _split_cores(4)
        return _t_run(core, tw.InterChipRouter(plan, device="cpu",
                                               **router_kw),
                      (4,), w, a, ev, ad)

    def test_modes_agree_within_budget(self):
        dense = self._runs(link_mode="dense")
        for mode in ("auto", "compact"):
            out = self._runs(link_mode=mode)
            np.testing.assert_array_equal(dense["spikes"].numpy(),
                                          out["spikes"].numpy())
            assert summary_counts(out["telemetry"])["link_overflows"] == 0
        assert summary_counts(dense["telemetry"])["routed_events"] > 0

    @pytest.mark.parametrize("kw", [dict(link_budget=4),
                                    dict(link_step_budget=1)])
    def test_auto_over_budget_is_bitexact_and_counted(self, kw):
        dense = self._runs(link_mode="dense")
        tiny = self._runs(link_mode="auto", **kw)
        np.testing.assert_array_equal(dense["spikes"].numpy(),
                                      tiny["spikes"].numpy())
        assert summary_counts(tiny["telemetry"])["link_overflows"] > 0

    def test_forced_compact_overflow_diverges_and_counts(self):
        dense = self._runs(link_mode="dense")
        tiny = self._runs(link_mode="compact", link_budget=4)
        assert not np.array_equal(dense["spikes"].numpy(),
                                  tiny["spikes"].numpy())
        assert summary_counts(tiny["telemetry"])["link_overflows"] > 0


def test_unknown_link_mode_raises():
    with pytest.raises(ValueError, match="link_mode"):
        tw.InterChipRouter(plans(2, "ring")[1], device="cpu",
                           link_mode="sparse")


# ---------------------------------------------------------------------------
# run_training(wafer=K) against the reference's
# ---------------------------------------------------------------------------

N_TRIALS = 8
ECFG_J = jh.RSTDPConfig(trial_steps=128)
ECFG = th.RSTDPConfig(trial_steps=128)


def _global_w(w):
    K, I, c = w.shape
    return np.asarray(w).transpose(1, 0, 2).reshape(I, K * c)


def _port_training(K, **kw):
    """The port's run with the reference's whole-network instance
    (``PRNGKey(0)``, ``run_training``'s seed) and draws (``PRNGKey(1)``)
    injected."""
    cfg = dataclasses.replace(J_BSS2.reduced(), n_rows=2 * ECFG.n_inputs,
                              n_cols=ECFG.n_neurons)
    inst = jax.tree.map(np.asarray, j_sample_instance(
        cfg, jax.random.PRNGKey(0), ()))
    draws = convert.replay_reference_draws(
        jax.random, jax.random.PRNGKey(1), th.stimuli(N_TRIALS), ECFG,
        device="cpu")
    if K:
        draws = th.wafer_draws(draws, K)
    return th.run_training(n_trials=N_TRIALS, ecfg=ECFG, device="cpu",
                           wafer=K, inst=convert.instance(inst, "cpu"),
                           draws=draws, **kw)


@pytest.mark.parametrize("K", [1, 2, 4])
def test_run_training_wafer_equal_to_reference(K):
    assert ECFG.trial_steps * 2 * ECFG.n_inputs * ECFG.n_neurons < \
        synapse.SPARSE_MIN_DENSE_WORK        # every window dense
    want, jstate, jmeta = jh.run_training(n_trials=N_TRIALS, ecfg=ECFG_J,
                                          seed=0, wafer=K, telemetry=True)
    got, state, meta = _port_training(K, telemetry=True)
    assert meta["router"].plan.n_routes == jmeta["router"].plan.n_routes
    np.testing.assert_array_equal(got["reward"], want["reward"])
    np.testing.assert_array_equal(got["rates"], want["rates"])
    close(got["w_signed_final"], want["w_signed_final"])
    np.testing.assert_array_equal(state.core.syn.weights.numpy(),
                                  np.asarray(jstate.core.syn.weights))
    close(state.routed, jstate.routed)
    for k in COUNTERS + ("trials", "dense_windows", "sparse_windows"):
        assert got["telemetry"][k] == int(want["telemetry"][k]), k
    assert got["telemetry"]["routed_events"] > 0


def test_chip_count_parity():
    """tests/test_wafer.py::TestClosedLoop::test_chip_count_parity_with_
    relay in the port: the same global weights and rewards bit for bit
    for K = 1, 2, 4, and every chip receives its own copy of the relay
    broadcast."""
    outs = {K: th.run_training(n_trials=N_TRIALS, ecfg=ECFG, seed=0,
                               device="cpu", wafer=K, telemetry=True)[0]
            for K in (1, 2, 4)}
    base = _global_w(outs[1]["w_signed_final"])
    r1 = outs[1]["telemetry"]["routed_events"]
    assert r1 > 0
    for K in (2, 4):
        np.testing.assert_array_equal(base,
                                      _global_w(outs[K]["w_signed_final"]))
        np.testing.assert_array_equal(
            outs[1]["reward"].reshape(N_TRIALS, -1),
            outs[K]["reward"].reshape(N_TRIALS, -1))
        assert outs[K]["telemetry"]["routed_events"] == K * r1
        assert outs[K]["telemetry"]["link_overflows"] == 0


def test_one_chip_without_relay_is_the_plain_experiment():
    plain = th.run_training(n_trials=N_TRIALS, ecfg=ECFG, seed=0,
                            device="cpu")[0]
    wafer, state, meta = th.run_training(n_trials=N_TRIALS, ecfg=ECFG,
                                         seed=0, device="cpu", wafer=1,
                                         wafer_relay=False)
    assert meta["router"] is not None and state.routed is not None
    np.testing.assert_array_equal(plain["w_signed_final"],
                                  wafer["w_signed_final"][0])
    np.testing.assert_array_equal(plain["reward"].reshape(N_TRIALS, -1),
                                  wafer["reward"].reshape(N_TRIALS, -1))


def test_wafer_modes_bit_equal():
    """``run_training``'s three modes in wafer mode: the trial body (the
    routed slot copied like every state leaf), eager trials and the host
    loop give the same histories and final state."""
    runs = [th.run_training(n_trials=4, ecfg=ECFG, seed=2, device="cpu",
                            wafer=2, telemetry=True, **kw)
            for kw in (dict(), dict(scan=False), dict(fused=False))]
    (o0, s0, _) = runs[0]
    for o, s, _ in runs[1:]:
        for k in o0:
            if k != "telemetry":
                np.testing.assert_array_equal(o[k], o0[k], err_msg=k)
        assert o["telemetry"] == o0["telemetry"]
        for x, y in zip(th._leaves(s), th._leaves(s0)):
            assert torch.equal(x, y)
    assert s0.routed.shape == (ECFG.trial_steps, 2, 2 * ECFG.n_inputs)


def test_wafer_argument_checks():
    with pytest.raises(ValueError, match="owns the instance prefix"):
        th.make_experiment(ecfg=ECFG, wafer=2, prefix=(2,), device="cpu")
    with pytest.raises(ValueError, match="even per-chip column"):
        th.make_experiment(ecfg=ECFG, wafer=16, device="cpu")
    with pytest.raises(ValueError, match="wafer_plan"):
        th.make_experiment(ecfg=ECFG, wafer=2, device="cpu",
                           wafer_plan=tw.s5_column_plan(4, 16, 16))


def test_const_addr_relay_window_follows_the_reference():
    """A known reference behaviour, mirrored: with ``const_addr`` (as the
    §5 experiment builds its core) the dense route takes each row's
    address at step 0, so a relay row whose routed event lands at t = 0
    carries the relay address (no match) for the whole window, while the
    sparse route's records keep their own addresses. Each route equals
    the reference's on the same routed window; the two routes differ."""
    rng = np.random.default_rng(4)
    j_plan, t_plan = plans(2, "ring")
    w = rng.integers(20, 60, (2, R, C)).astype(np.int8)
    a = np.zeros((2, R, C), np.int8)         # the §5 synapses: address 0
    ev = (rng.random((T, 2, R)) < 0.3).astype(np.float32)
    routed = (rng.random((T, 2, R)) < 0.3).astype(np.float32)
    routed *= t_plan.relay_rows()[None].astype(np.float32)
    routed[0] = t_plan.relay_rows().astype(np.float32)     # t = 0 lands
    inst = jax.tree.map(np.asarray, j_sample_instance(
        CFG_J, jax.random.PRNGKey(3), (2,)))
    outs = {}
    for mode in ("never", "always"):
        j_core = JAnnCore(CFG_J, inst, backend="fused", const_addr=True,
                          sparse_mode=mode)
        t_core = AnnCore(CFG, convert.instance(inst, "cpu"), backend="fused",
                         const_addr=True, sparse_mode=mode)
        js = j_core.init_state((2,))
        js = js._replace(syn=js.syn._replace(weights=jnp.asarray(w),
                                             addresses=jnp.asarray(a)))
        ts = t_core.init_state((2,))
        ts = ts._replace(syn=ts.syn._replace(weights=torch.from_numpy(w),
                                             addresses=torch.from_numpy(a)))
        _, jo = j_core.run_routed(js, jnp.asarray(routed), jnp.asarray(ev),
                                  jnp.zeros(ev.shape, jnp.int8),
                                  jw.InterChipRouter(j_plan), record_v=True)
        _, to = t_core.run_routed(ts, torch.from_numpy(routed),
                                  torch.from_numpy(ev),
                                  torch.zeros(ev.shape, dtype=torch.int8),
                                  tw.InterChipRouter(t_plan, device="cpu"),
                                  record_v=True)
        close(to["v"], jo["v"])
        np.testing.assert_array_equal(to["spikes"].numpy(),
                                      np.asarray(jo["spikes"]))
        outs[mode] = to["v"]
    assert not torch.equal(outs["never"], outs["always"])
