"""The link half of fault injection in the port against the reference
(the wafer cases of tests/test_faults.py).

- ``TestLinkFailover``'s five cases, each held to the reference's outputs
  on the same plan and spikes: a dead link's traffic re-arrives over the
  reroute's forwards exactly one window late and counts in
  ``link_reroutes``; ``route`` without ``routed_in`` on a failover plan
  raises; a ring with no detour is promoted to all2all; an impossible
  failover raises; a flaky link drops the same events every call, the
  reference's events.
- ``screen_links`` and ``screen(router=)`` equal to the reference's
  verdicts on the same plan and faults.
- ``run_training(wafer=4, faults=, blacklist=)`` with a link blacklist,
  and ``wafer=3`` on a ring promoted to all2all (the injected link faults
  carried over by ``remap_link_faults``), with the reference's instance
  and draws: rewards, 6-bit weights and link counters exact, the signed
  weights within rtol = atol = 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close
from repro.configs.bss2 import BSS2 as J_BSS2
from repro.core import hybrid as jh
from repro.core.anncore import AnnCore as JAnnCore
from repro.core.ppu import VectorUnit as JVectorUnit
from repro.faults import FaultPlan as JFaultPlan
from repro.faults import blacklist as j_blacklist
from repro.obs import trace as j_trace
from repro.verif.mismatch import sample_instance as j_sample_instance
from repro import wafer as jw
from repro_torch import convert
from repro_torch.configs.bss2 import BSS2
from repro_torch.core import hybrid as th
from repro_torch.core.anncore import AnnCore
from repro_torch.core.ppu import VectorUnit
from repro_torch.faults import Blacklist, FaultPlan, screen, screen_links
from repro_torch.obs import trace as obs_trace
from repro_torch import wafer as tw

R, C = 16, 8
LINK_COUNTERS = ("routed_events", "link_overflows", "link_events_max",
                 "link_reroutes", "faults_injected", "faults_detected")


def _spikes(t, K, c, key=0, p=0.4):
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(key), (t, K, c))
                      < p, np.float32)


def _pair(plan_j, faults=None, **kw):
    """The reference's router on ``plan_j`` and the port's on the same
    plan, with the same link faults."""
    jf = None if faults is None else _as_ref(faults)
    return (jw.InterChipRouter(plan_j, faults=jf, **kw),
            tw.InterChipRouter(convert.plan(plan_j), device="cpu",
                               faults=faults, **kw))


class TestLinkFailover:
    def test_dead_link_traffic_rearrives_and_is_counted(self):
        plan = jw.s5_column_plan(4, R // 2, 16)
        dead = (0, 2)
        p2, n_re = jw.reroute_plan(plan, [dead])
        assert n_re == 4 and p2.n_forwards == 4
        fp = FaultPlan(dead_links=np.array(
            [sd == dead for sd in plan.topology.links()]))
        jr, tr = _pair(p2, fp)
        t_clean = tw.InterChipRouter(convert.plan(plan), device="cpu")
        sp1 = _spikes(8, 4, 4)
        silent = np.zeros_like(sp1)
        j_tele = j_trace.init_telemetry()
        jg1, j_tele = jr.route(jnp.asarray(sp1), j_tele,
                               routed_in=jr.init_buffer(8))
        jg2, j_tele = jr.route(jnp.asarray(silent), j_tele, routed_in=jg1)
        tele = obs_trace.init_telemetry("cpu")
        g1c, _ = t_clean.route(torch.from_numpy(sp1))
        g1f, tele = tr.route(torch.from_numpy(sp1), tele,
                             routed_in=tr.init_buffer(8))
        g2f, tele = tr.route(torch.from_numpy(silent), tele, routed_in=g1f)
        np.testing.assert_array_equal(g1f.numpy(), np.asarray(jg1))
        np.testing.assert_array_equal(g2f.numpy(), np.asarray(jg2))
        missing = np.maximum(g1c.numpy()[:, 2] - g1f.numpy()[:, 2], 0.0)
        assert missing.sum() > 0
        # the dead link's deliveries re-arrive exactly one window late
        np.testing.assert_array_equal(g2f.numpy()[:, 2], missing)
        s, js = obs_trace.summary(tele), j_trace.summary(j_tele)
        assert s["link_reroutes"] == int((missing > 0).sum())
        assert s["faults_injected"] == 1
        for k in LINK_COUNTERS:
            assert s[k] == int(js[k]), k

    def test_route_requires_routed_in_on_failover_plans(self):
        p2, _ = tw.reroute_plan(tw.s5_column_plan(4, R // 2, 16), [(0, 2)])
        with pytest.raises(ValueError, match="routed_in"):
            tw.InterChipRouter(p2, device="cpu").route(
                torch.from_numpy(_spikes(8, 4, 4)))

    def test_ring_promotes_to_all2all(self):
        plan = tw.make_plan(tw.WaferTopology(3, "ring"), 4, 2,
                            [(0, 0, 1, 0, 7), (1, 1, 2, 1, 9),
                             (2, 0, 0, 2, 11)])
        p2, n = tw.reroute_plan(plan, [(1, 2)])
        assert n == 1 and p2.topology.kind == "all2all"
        assert p2.n_forwards == 1
        # the relay hop rides alive links only
        assert (int(p2.fwd_src_chip[0]), int(p2.fwd_dst_chip[0])) != (1, 2)

    def test_reroute_raises_when_impossible(self):
        plan = tw.make_plan(tw.WaferTopology(2, "all2all"), 4, 2,
                            [(0, 0, 1, 0, 7)])
        with pytest.raises(ValueError, match="no failover"):
            tw.reroute_plan(plan, [(0, 1)])

    def test_flaky_link_drops_deterministically(self):
        plan = jw.s5_column_plan(2, R // 2, 16)
        fl = np.zeros(len(plan.topology.links()), np.float32)
        fl[0] = 0.5
        jr, tr = _pair(plan, FaultPlan(flaky_links=fl, seed=4))
        sp = np.ones((64, 2, 8), np.float32)
        n1 = tr.link_census(torch.from_numpy(sp)).numpy()
        n2 = tr.link_census(torch.from_numpy(sp)).numpy()
        np.testing.assert_array_equal(n1, n2)
        np.testing.assert_array_equal(n1,
                                      np.asarray(jr.link_census(
                                          jnp.asarray(sp))))
        n_clean = tw.InterChipRouter(convert.plan(plan), device="cpu"
                                     ).link_census(torch.from_numpy(sp))
        frac = n1[0] / int(n_clean[0])
        assert 0.3 < frac < 0.7, frac
        np.testing.assert_array_equal(n1[1:], n_clean.numpy()[1:])


@pytest.mark.parametrize("K,kind,dead,flaky", [
    (4, "all2all", [(0, 2)], [((1, 3), 0.5)]),
    (4, "all2all", [], [((2, 2), 0.2), ((3, 0), 0.04)]),
    (3, "all2all", [(1, 2), (2, 0)], []),
    (4, "ring", [(3, 0)], [((1, 2), 0.9)])])
def test_screen_links_equal_to_reference(K, kind, dead, flaky):
    """The link verdicts of both packages on the same plan and faults, a
    flaky link below the 0.95 bar left out by both."""
    routes = [(s, c, d, (c + 3 * s) % R, 7) for s in range(K)
              for d in ([(s + 1) % K] if kind == "ring" else range(K))
              for c in range(C)]
    plan = jw.make_plan(jw.WaferTopology(K, kind), R, C, routes)
    links = plan.topology.links()
    fl = np.zeros(len(links), np.float32)
    for sd, f in flaky:
        fl[links.index(sd)] = f
    fp = FaultPlan(dead_links=np.array([sd in dead for sd in links]),
                   flaky_links=fl if flaky else None, seed=2)
    jr, tr = _pair(plan, fp)
    want = j_blacklist.screen_links(jr)
    got = screen_links(tr)
    assert got == want
    assert set(dead) <= set(got)


def test_screen_full_pass_with_router():
    """tests/test_faults.py::TestLinkFailover::test_screen_full_pass_with_
    router, against the reference's ``screen``."""
    cfg_j = dataclasses.replace(J_BSS2.reduced(), n_rows=R, n_cols=C)
    cfg = dataclasses.replace(BSS2.reduced(), n_rows=R, n_cols=C)
    inst = jax.tree.map(np.asarray, j_sample_instance(
        cfg_j, jax.random.PRNGKey(0), ()))
    plan = jw.s5_column_plan(4, R // 2, 16)
    dl = np.array([sd == (3, 1) for sd in plan.topology.links()])
    fp = FaultPlan(dead_links=dl)
    jr, tr = _pair(plan, fp)
    jfp = _as_ref(fp)
    want = j_blacklist.screen(JAnnCore(cfg_j, inst, faults=jfp),
                              JVectorUnit(cfg_j, inst, faults=jfp),
                              router=jr)
    inst_t = convert.instance(inst, "cpu")
    got = screen(AnnCore(cfg, inst_t, faults=fp),
                 VectorUnit(cfg, inst_t, faults=fp), router=tr)
    assert got.links == want.links == ((3, 1),)
    np.testing.assert_array_equal(got.rows, want.rows)
    np.testing.assert_array_equal(got.neurons, want.neurons)
    assert got.n_rows == 0 and got.n_neurons == 0


N_TRIALS = 12


def _as_ref(plan):
    return JFaultPlan(**{f.name: getattr(plan, f.name)
                         for f in dataclasses.fields(plan)})


def _runs(n_neurons, wafer, wafer_plan=None, faults=None, blacklist=None):
    """``run_training`` of both packages on the same whole-network
    instance and draws (seed 1)."""
    ecfg_j = jh.RSTDPConfig(n_neurons=n_neurons, trial_steps=128)
    ecfg = th.RSTDPConfig(n_neurons=n_neurons, trial_steps=128)
    want, jstate, jmeta = jh.run_training(
        n_trials=N_TRIALS, ecfg=ecfg_j, seed=1, telemetry=True, wafer=wafer,
        wafer_plan=wafer_plan, faults=None if faults is None
        else _as_ref(faults), blacklist=j_blacklist.Blacklist(
            rows=blacklist.rows, neurons=blacklist.neurons,
            links=blacklist.links))
    kw = dict(wafer=wafer, faults=faults, blacklist=blacklist,
              wafer_plan=None if wafer_plan is None
              else convert.plan(wafer_plan))
    cfg = dataclasses.replace(J_BSS2.reduced(), n_rows=2 * ecfg.n_inputs,
                              n_cols=n_neurons)
    inst = jax.tree.map(np.asarray, j_sample_instance(
        cfg, jax.random.PRNGKey(1), ()))
    draws = th.wafer_draws(convert.replay_reference_draws(
        jax.random, jax.random.PRNGKey(2), th.stimuli(N_TRIALS), ecfg,
        device="cpu"), wafer)
    got, state, meta = th.run_training(
        n_trials=N_TRIALS, ecfg=ecfg, device="cpu", telemetry=True,
        inst=convert.instance(inst, "cpu"), draws=draws, **kw)
    np.testing.assert_array_equal(got["reward"], want["reward"])
    close(got["w_signed_final"], want["w_signed_final"])
    np.testing.assert_array_equal(state.core.syn.weights.numpy(),
                                  np.asarray(jstate.core.syn.weights))
    for k in LINK_COUNTERS:
        assert got["telemetry"][k] == int(want["telemetry"][k]), k
    assert (meta["router"].plan.topology.links()
            == jmeta["router"].plan.topology.links())
    for k in ("fwd_src_chip", "fwd_src_row", "fwd_dst_chip", "fwd_dst_row"):
        np.testing.assert_array_equal(getattr(meta["router"].plan, k),
                                      getattr(jmeta["router"].plan, k))
    return got, meta


def test_link_blacklist_run_equal_to_reference():
    """tests/test_faults.py::TestClosedLoop::test_wafer_blacklisted_link_
    reroutes_and_learns' setting over 12 trials: the blacklisted link
    (0, 2) is rerouted over 4 forwards, the rerouted traffic counted, and
    the run equals the reference's."""
    bl = Blacklist(rows=np.zeros((4, 32), bool),
                   neurons=np.zeros((4, 4), bool), links=((0, 2),))
    got, meta = _runs(16, wafer=4, blacklist=bl)
    assert meta["router"].plan.n_forwards == 4
    assert got["telemetry"]["link_reroutes"] > 0


def test_ring_promotion_remaps_link_faults_in_the_run():
    """A ring plan with no detour around a blacklisted link is promoted to
    all2all; a flaky link injected in the ring's link order keeps hitting
    the same chip pair (``remap_link_faults``), in both packages."""
    K, c_loc = 3, 4
    routes = [(s, c, (s + 1) % K, 2 * (4 * s + c), 63) for s in range(K)
              for c in range(c_loc)]
    plan = jw.make_plan(jw.WaferTopology(K, "ring"), 32, c_loc, routes)
    fp = FaultPlan(flaky_links=np.array([0.5, 0.0, 0.0], np.float32),
                   seed=3)
    bl = Blacklist(rows=np.zeros((K, 32), bool),
                   neurons=np.zeros((K, c_loc), bool), links=((1, 2),))
    got, meta = _runs(K * c_loc, wafer=K, wafer_plan=plan, faults=fp,
                      blacklist=bl)
    router = meta["router"]
    assert router.plan.topology.kind == "all2all"
    links = router.plan.topology.links()
    flaky = router.faults[0].flaky_links.numpy()
    assert flaky[links.index((0, 1))] == np.float32(0.5)
    assert flaky.sum() == np.float32(0.5)
    assert got["telemetry"]["link_reroutes"] > 0
