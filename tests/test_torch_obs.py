"""Telemetry in the port (``repro_torch.obs``) against the reference
(``repro.obs``): free when off, honest when on.

- Bit-exactness: telemetry on and off give identical histories and final
  states (``torch.equal``) in all three modes of ``run_training``, for
  both rules, below and above the census floor; identical currents from
  the synaptic window on every route.
- Counter correctness: every update helper equal to the reference's on
  the same inputs (exact: counts of whole things); a window's route
  counters and a 7-trial ``run_training(telemetry=True)`` at 32 x 16 equal
  to the reference's on the same instance and injected draws (python and
  vm rules); the hand-count tests of tests/test_obs.py:106-215 and
  ``test_instance_prefix_counters`` on the port.
- A summary read does not recapture: after ``summary()`` and
  ``build_report``, a second call of ``make_scanned_training`` with the
  same shapes runs the same loop (on a card: replays the same graph; the
  card's test counts the timer's ``graph.captures``), not a new one.
- Phase timer (spans, counters, regions, off), the kernel build's span and
  counters, ``scanned_training``'s spans (on and off bit-equal, one
  sample a call), ``profile_phases``, the profiler hook, the run report,
  and playback with telemetry (the golden traces replay unchanged with
  ``telemetry=True``).
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ppuvm as corpus
from _torch_parity import close, t
from repro.core import hybrid as jh
from repro.core import synapse as j_synapse
from repro.obs import trace as j_trace
from repro_torch import convert
from repro_torch.configs.bss2 import BSS2
from repro_torch.core import hybrid as th
from repro_torch.core import synapse
from repro_torch.core.anncore import AnnCore
from repro_torch.faults import FaultPlan
from repro_torch.obs import report as obs_report
from repro_torch.obs import timing as obs_timing
from repro_torch.obs import trace as obs_trace
from repro_torch.ppuvm import isa, programs
from repro_torch.verif import playback as pb
from repro_torch.verif.mismatch import ideal_instance, sample_instance

CPU = "cpu"


def _events(T, R, seed=0, p=0.05):
    rng = np.random.default_rng(seed)
    return ((rng.random((T, R)) < p).astype(np.float32),
            np.zeros((T, R), np.int8))


def _geometry(name):
    if name == "reduced":
        return dict(ecfg=th.RSTDPConfig(trial_steps=96))
    return dict(ecfg=th.RSTDPConfig(n_inputs=64, n_neurons=256,
                                    pattern_size=16, trial_steps=128),
                cfg=dataclasses.replace(BSS2, n_rows=128, n_cols=256))


# ---------------------------------------------------------------------------
# Bit-exactness: telemetry never touches the numbers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("geometry,rule_impl", [("reduced", "python"),
                                                ("reduced", "vm"),
                                                ("gated", "python")])
@pytest.mark.parametrize("mode", ["scan", "eager", "host"])
def test_training_on_off_bit_exact(geometry, rule_impl, mode):
    kw = dict(scan=dict(scan=True), eager=dict(scan=False),
              host=dict(fused=False))[mode]
    runs = {}
    for on in (True, False):
        synapse.reset_route_counts()
        out, state, _ = th.run_training(6, seed=2, device=CPU,
                                        rule_impl=rule_impl, telemetry=on,
                                        **kw, **_geometry(geometry))
        runs[on] = out, state, synapse.route_counts(CPU).tolist()
    (on, s_on, r_on), (off, s_off, r_off) = runs[True], runs[False]
    assert "telemetry" not in off and s_off.tele is None
    assert r_on == r_off
    for k in off:
        np.testing.assert_array_equal(on[k], off[k], err_msg=k)
    for a, b in zip(th._leaves(s_on.core), th._leaves(s_off.core)):
        assert torch.equal(a, b)
    tele = on["telemetry"]
    T = _geometry(geometry)["ecfg"].trial_steps
    assert tele["trials"] == 6 and tele["steps"] == 6 * T
    assert tele["dw_updates"] == 6
    assert tele["out_spikes"] == int(on["rates"].sum())
    assert tele["rate_total"] == float(on["rates"].sum())
    assert tele["vm_runs"] == (6 if rule_impl == "vm" else 0)
    if geometry == "gated":
        assert tele["gated_windows"] == 12
        assert [tele["dense_windows"], tele["sparse_windows"]] == r_on
    else:
        assert tele["dense_windows"] == 12 and tele["gated_windows"] == 0


@pytest.mark.parametrize("mode", ["auto", "never", "always"])
def test_window_on_off_and_counters_match_reference(mode):
    """A window above the census floor on every route: the same currents
    with telemetry on and off, and the route counters equal to the
    reference's (the gate's census maxima included); with too small a
    capacity, the counted overflow fallback."""
    T, R, C = 512, 64, 64
    ev, ad = _events(T, R, p=0.01)
    w = np.random.default_rng(1).integers(0, 64, (R, C)).astype(np.int8)
    a = np.zeros((R, C), np.int8)
    for extra in (dict(), dict(max_events=4)):
        if mode != "auto" and extra:
            continue
        i_off = synapse.synaptic_current_window(
            t(w), t(a), t(ev), t(ad), 1.0, sparse=mode, **extra)
        i_on, tele = synapse.synaptic_current_window(
            t(w), t(a), t(ev), t(ad), 1.0, sparse=mode,
            telemetry=obs_trace.init_telemetry(CPU), **extra)
        assert torch.equal(i_off, i_on)
        _, j_tele = j_synapse.synaptic_current_window(
            jnp.asarray(w), jnp.asarray(a), jnp.asarray(ev),
            jnp.asarray(ad), 1.0, sparse=mode,
            telemetry=j_trace.init_telemetry(), **extra)
        assert obs_trace.summary(tele) == j_trace.summary(j_tele)


# ---------------------------------------------------------------------------
# Counter correctness: the helpers against the reference's
# ---------------------------------------------------------------------------

def _helper_inputs(rng):
    sp = (rng.random((40, 3, 16)) < 0.3).astype(np.float32)
    ev = ((rng.random((40, 3, 32)) < 0.2)
          * rng.uniform(0.1, 1, (40, 3, 32))).astype(np.float32)
    regs = rng.choice([isa.I16MAX, isa.I16MIN, 0, 5, -7],
                      (8, 3, 4, 16)).astype(np.int32)
    w_old = rng.uniform(-45, 45, (3, 4, 16)).astype(np.float32)
    dw = rng.choice([0.0, 1 / 512, 1 / 64, 0.1, 0.3, 0.5, 1.0, 3.0, 40.0],
                    w_old.shape) * rng.choice([-1, 1], w_old.shape)
    w_new = (w_old + dw).astype(np.float32)
    n_link = rng.integers(0, 300, 6).astype(np.int32)
    fits = rng.random(6) < 0.7
    census = np.asarray([rng.random() < 0.5, rng.integers(0, 900),
                         rng.integers(0, 40)], np.int32)
    plans = (FaultPlan(dead_rows=rng.random(32) < 0.2,
                       hot_neurons=rng.random(16) < 0.2),
             FaultPlan(dead_rows=rng.random(32) < 0.2,
                       dead_neurons=rng.random(16) < 0.2,
                       is_blacklist=True))
    return dict(sp=sp, ev=ev, regs=regs, w_old=w_old, w_new=w_new,
                n_link=n_link, fits=fits, census=census, plans=plans,
                rates=(rng.integers(0, 90, (3, 16))).astype(np.float32),
                n_fwd=np.int32(rng.integers(0, 50)))


def _update(mod, tele, name, x, arr):
    if name == "count_run":
        return mod.count_run(tele, arr(x["ev"]), arr(x["sp"]))
    if name == "count_route":
        return mod.count_route(mod.count_route(tele, True), False)
    if name == "count_gate":
        c = arr(x["census"])
        return mod.count_gate(tele, c[0] > 0, c[1], c[2])
    if name == "count_links":
        return mod.count_links(tele, arr(x["n_link"]), arr(x["fits"]))
    if name == "count_trial":
        return mod.count_trial(tele, arr(x["rates"]))
    if name == "count_vm":
        return mod.count_vm(tele, arr(x["regs"]))
    if name == "count_dw":
        return mod.count_dw(tele, arr(x["w_old"]), arr(x["w_new"]))
    if name == "count_faults":
        plans = x["plans"]
        if mod is j_trace:
            from repro.faults import model as jm
            plans = tuple(jm.FaultPlan(**{f.name: getattr(p, f.name)
                                          for f in dataclasses.fields(p)})
                          for p in plans)
        return mod.count_faults(tele, plans)
    return mod.count_reroutes(tele, arr(x["n_fwd"]))


HELPERS = ("count_run", "count_route", "count_gate", "count_links",
           "count_trial", "count_vm", "count_dw", "count_faults",
           "count_reroutes")


@pytest.mark.parametrize("name", HELPERS)
def test_helper_equal_to_reference(name):
    """Twice in a row (the running maxima and sums too): every counter
    equal to the reference's, and ``None`` in gives ``None`` out."""
    rng = np.random.default_rng(HELPERS.index(name))
    xs = [_helper_inputs(rng), _helper_inputs(rng)]
    tele, j_tele = obs_trace.init_telemetry(CPU), j_trace.init_telemetry()
    for x in xs:
        tele = _update(obs_trace, tele, name, x, t)
        j_tele = _update(j_trace, j_tele, name, x, jnp.asarray)
    got, want = obs_trace.summary(tele), j_trace.summary(j_tele)
    assert got == want
    assert got != obs_trace.summary(obs_trace.init_telemetry(CPU))
    assert _update(obs_trace, None, name, xs[0], t) is None
    for f, v in tele._asdict().items():
        assert v.dtype == (torch.float32 if f in ("rate_total", "dw_abs_max")
                           else torch.int32), f


@pytest.mark.parametrize("rule_impl", ["python", "vm"])
def test_run_training_counters_match_reference(rule_impl):
    """7 trials at 32 x 16 with the reference's instance and draws: every
    counter of the port's ``run_training(telemetry=True)`` equal to the
    reference's scanned training with telemetry, |dw| maximum within
    1e-4 (the signed weights' tolerance)."""
    n = 7
    ecfg = jh.RSTDPConfig()
    init, _, meta = jh.make_experiment(
        ecfg=ecfg, instance_key=jax.random.PRNGKey(0), rule_impl=rule_impl,
        telemetry=True)
    inst = jax.tree.map(np.array, meta["inst"])
    st0 = init(jax.random.PRNGKey(1))
    stims = th.stimuli(n)
    draws = convert.replay_reference_draws(
        jax.random, jnp.array(st0.key), stims, th.RSTDPConfig(), device=CPU)
    j_state, _ = jh.make_scanned_training(meta["scanned_training"])(
        st0, jnp.asarray(stims))
    want = j_trace.summary(j_state.tele)
    out, _, _ = th.run_training(n, device=CPU, rule_impl=rule_impl,
                                inst=convert.instance(inst, CPU),
                                draws=draws, telemetry=True)
    got = out["telemetry"]
    close(got.pop("dw_abs_max"), want.pop("dw_abs_max"))
    assert got == want
    assert want["out_spikes"] > 0 and want["vm_runs"] == (
        n if rule_impl == "vm" else 0)


# ---------------------------------------------------------------------------
# Hand counts (tests/test_obs.py:106-215)
# ---------------------------------------------------------------------------

def test_run_counters_match_hand_count():
    cfg = BSS2.reduced()
    core = AnnCore(cfg, ideal_instance(cfg, device=CPU))
    state = core.init_state()
    state = state._replace(syn=state.syn._replace(
        weights=torch.full((cfg.n_rows, cfg.n_cols), 45, dtype=torch.int8)))
    ev, ad = _events(96, cfg.n_rows, p=0.04)
    state, out = core.run(state, t(ev), t(ad),
                          telemetry=obs_trace.init_telemetry(CPU))
    s = obs_trace.summary(out["telemetry"])
    assert s["steps"] == 96
    assert s["in_events"] == int(np.count_nonzero(ev))
    assert s["out_spikes"] == int(out["spikes"].sum())


def test_core_built_with_telemetry_counts_each_call():
    cfg = BSS2.reduced()
    core = AnnCore(cfg, ideal_instance(cfg, device=CPU), telemetry=True)
    ev, ad = map(t, _events(32, cfg.n_rows))
    _, out = core.run(core.init_state(), ev, ad)
    assert obs_trace.summary(out["telemetry"])["steps"] == 32
    _, out = core.run(core.init_state(), ev, ad)
    assert obs_trace.summary(out["telemetry"])["steps"] == 32


def test_gate_counters_sparse_fit_and_overflow():
    T, R, C = 1024, 256, 256
    ev, ad = _events(T, R, seed=3, p=0.002)
    w = torch.full((R, C), 20, dtype=torch.int8)
    a = torch.zeros((R, C), dtype=torch.int8)
    n_ev = int(np.count_nonzero(ev))
    k_max = int(ev.astype(bool).sum(axis=1).max())
    _, tele = synapse.synaptic_current_window(
        w, a, t(ev), t(ad), 1.0, sparse="auto",
        telemetry=obs_trace.init_telemetry(CPU))
    s = obs_trace.summary(tele)
    assert s["gated_windows"] == 1 and s["sparse_windows"] == 1
    assert s["dense_windows"] == 0 and s["overflow_fallbacks"] == 0
    assert s["census_events_max"] == n_ev and s["census_k_max"] == k_max
    i_over, tele = synapse.synaptic_current_window(
        w, a, t(ev), t(ad), 1.0, sparse="auto", max_events=4,
        telemetry=obs_trace.init_telemetry(CPU))
    s = obs_trace.summary(tele)
    assert s["overflow_fallbacks"] == 1 and s["dense_windows"] == 1
    assert s["sparse_windows"] == 0
    i_dense = synapse.synaptic_current_window(w, a, t(ev), t(ad), 1.0,
                                              sparse="never")
    assert torch.equal(i_over, i_dense)


def test_gate_counters_static_routes():
    ev, ad = map(t, _events(32, 16, p=0.1))
    w = torch.ones((16, 16), dtype=torch.int8)
    a = torch.zeros((16, 16), dtype=torch.int8)
    _, tele = synapse.synaptic_current_window(
        w, a, ev, ad, 1.0, sparse="auto",
        telemetry=obs_trace.init_telemetry(CPU))
    s = obs_trace.summary(tele)
    assert s["dense_windows"] == 1 and s["gated_windows"] == 0
    _, tele = synapse.synaptic_current_window(
        w, a, ev, ad, 1.0, sparse="always",
        telemetry=obs_trace.init_telemetry(CPU))
    assert obs_trace.summary(tele)["sparse_windows"] == 1


def test_count_vm_saturation_hand_count():
    regs = torch.stack([torch.full((4, 4), isa.I16MAX, dtype=torch.int32),
                        torch.full((4, 4), isa.I16MIN, dtype=torch.int32),
                        torch.zeros((4, 4), dtype=torch.int32)])
    s = obs_trace.summary(obs_trace.count_vm(obs_trace.init_telemetry(CPU),
                                             regs))
    assert s["vm_runs"] == 1 and s["vm_sat_hits"] == 32
    assert obs_trace.count_vm(None, regs) is None


def test_dw_histogram_hand_count():
    """Values between the edges and on every edge (left side: a value on
    an edge stays in the bin below it), as ``np.searchsorted`` bins."""
    w_new = torch.cat([torch.tensor([0.0, 1 / 512, 0.1, 0.3, 1.5, 5.0,
                                     31.0, 40.0]),
                       torch.as_tensor(obs_trace.DW_EDGES)])
    w_old = torch.zeros_like(w_new)
    s = obs_trace.summary(obs_trace.count_dw(obs_trace.init_telemetry(CPU),
                                             w_old, w_new))
    expect = np.zeros(obs_trace.DW_BINS, np.int64)
    for b in np.searchsorted(obs_trace.DW_EDGES, w_new.numpy()):
        expect[b] += 1
    assert s["dw_hist"] == expect.tolist()
    assert s["dw_updates"] == 1 and s["dw_abs_max"] == pytest.approx(40.0)
    assert s["dw_hist_edges"] == obs_trace.DW_EDGES.tolist()


def test_update_helpers_identity_on_none():
    z = torch.zeros(4, 4)
    assert obs_trace.count_run(None, z, z) is None
    assert obs_trace.count_route(None, sparse=True) is None
    assert obs_trace.count_trial(None, torch.zeros(4)) is None
    assert obs_trace.count_dw(None, torch.zeros(4), torch.ones(4)) is None
    assert obs_trace.count_faults(None, FaultPlan(
        dead_rows=np.ones(3, bool))) is None
    tele = obs_trace.init_telemetry(CPU)
    assert obs_trace.count_faults(tele, None) is tele
    assert obs_trace.count_reroutes(tele, None) is tele
    assert obs_trace.summary(None) is None


def test_init_telemetry_distinct_buffers():
    """One tensor per field: a captured trial copies each into its own
    state tensor."""
    ptrs = [x.data_ptr() for x in obs_trace.init_telemetry(CPU)]
    assert len(set(ptrs)) == len(ptrs)


def test_instance_prefix_counters():
    """Counters are fleet-wide totals: a [2]-instance prefix doubles the
    per-instance event count in one run."""
    cfg = BSS2.reduced()
    inst = sample_instance(cfg, torch.Generator().manual_seed(0), (2,),
                           device=CPU)
    core = AnnCore(cfg, inst)
    state = core.init_state((2,))
    state = state._replace(syn=state.syn._replace(
        weights=torch.full((2, cfg.n_rows, cfg.n_cols), 45,
                           dtype=torch.int8)))
    ev, ad = _events(64, cfg.n_rows, p=0.05)
    ev2 = t(np.broadcast_to(ev[:, None, :], (64, 2, cfg.n_rows)))
    ad2 = t(np.broadcast_to(ad[:, None, :], (64, 2, cfg.n_rows)))
    _, out = core.run(state, ev2, ad2,
                      telemetry=obs_trace.init_telemetry(CPU))
    s = obs_trace.summary(out["telemetry"])
    assert s["in_events"] == 2 * int(np.count_nonzero(ev))
    assert s["out_spikes"] == int(out["spikes"].sum())


# ---------------------------------------------------------------------------
# A summary read does not recapture
# ---------------------------------------------------------------------------

def test_summary_read_does_not_recapture():
    """The port's form of tests/test_obs.py::test_summary_emission_zero_
    retrace, held to its contract: ``make_scanned_training`` called again
    with the same shapes after a summary and a report runs the loop it
    built the first time (on a card: replays its captured graph), and the
    second run equals a fresh experiment's run of the same inputs."""
    ecfg = th.RSTDPConfig(trial_steps=64)
    init, _, meta = th.make_experiment(ecfg=ecfg, telemetry=True,
                                       device=CPU)
    scanned = th.make_scanned_training(meta)
    stims = [1, 2, 0, 1]
    d1 = meta["draw"](torch.Generator().manual_seed(1), stims)
    d2 = meta["draw"](torch.Generator().manual_seed(2), stims)
    state, _ = scanned(init(), stims, d1)
    loop = next(iter(scanned.loops.values()))[0]
    obs_report.build_report("t", telemetry=obs_trace.summary(state.tele))
    state2, hist2 = scanned(init(), stims, d2)
    assert len(scanned.loops) == 1
    assert next(iter(scanned.loops.values()))[0] is loop
    init_f, _, meta_f = th.make_experiment(ecfg=ecfg, telemetry=True,
                                           device=CPU)
    state_f, hist_f = th.make_scanned_training(meta_f)(init_f(), stims, d2)
    for k in hist_f:
        assert torch.equal(hist2[k], hist_f[k]), k
    for a, b in zip(th._leaves(state2), th._leaves(state_f)):
        assert torch.equal(a, b)
    assert obs_trace.summary(state2.tele)["trials"] == 4


# ---------------------------------------------------------------------------
# Phase timing and reports
# ---------------------------------------------------------------------------

def test_phase_timer_spans():
    tm = obs_timing.PhaseTimer(CPU)
    with tm.span("a"):
        torch.ones(4) * 2
    tm.time_fn("b", lambda x: x + 1, torch.ones(3), iters=2)
    s = tm.summary()
    assert s["a"]["count"] == 1 and s["b"]["count"] == 2
    assert s["b"]["best_us"] <= s["b"]["mean_us"] + 1e-9


def test_phase_timer_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        obs_timing.PhaseTimer()


def test_phase_timer_counters_regions_and_off():
    """Counters beside the spans in ``summary()`` (a counter is
    ``{count}``, a span keeps count / total / mean / best), regions folded
    by ``take``, and a timer that is off records nothing and makes no
    regions."""
    tm = obs_timing.PhaseTimer(CPU)
    tm.count("n")
    tm.count("n", 4)
    with tm.span("h", host=True):
        pass
    r = tm.regions(("x", "y"))
    for i in range(3):
        r.mark(i)
    tm.take(r)
    s = tm.summary()
    assert s["n"] == dict(count=5)
    for name in ("h", "x", "y"):
        assert set(s[name]) == {"count", "total_us", "mean_us", "best_us"}
        assert s[name]["count"] == 1 and s[name]["total_us"] >= 0
    assert tm.samples["x"][0] == r.marks[1] - r.marks[0]
    off = obs_timing.PhaseTimer(CPU, enabled=False)
    with off.span("a"):
        pass
    off.count("n")
    assert off.regions(("x",)) is None and off.summary() == {}


def test_phase_timer_rearm_counts_a_lost_sample():
    """A ``Regions`` recorded again while its sample is still pending (a
    caller running ahead of the card) loses that sample: ``rearm`` counts
    it in ``timer.dropped``, and each recording is taken once; a sample
    that has completed is folded in, not dropped."""

    class Slow(obs_timing.Regions):
        ready = False

        def done(self):
            return self.ready

    tm = obs_timing.PhaseTimer(CPU)
    r = Slow(("x",), CPU)
    tm.rearm(r)
    r.mark(0), r.mark(1)
    tm.take(r)
    assert tm.counters == {}
    tm.rearm(r)
    assert tm.counters == {"timer.dropped": 1}
    r.mark(0), r.mark(1)
    tm.take(r)
    r.ready = True
    tm.rearm(r)
    r.mark(0), r.mark(1)
    tm.take(r)
    assert tm.counters == {"timer.dropped": 1}
    assert tm.summary()["x"]["count"] == 2


def test_kernel_build_counts_a_reused_library(tmp_path, monkeypatch):
    """``kernels._build.build`` is a host span ``kernels.build`` of the
    process-wide timer and counts a library whose hash matches as
    ``kernels.reused`` (no compiler runs)."""
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    lib = tmp_path / f"librepro_torch_{_build._digest()}.so"
    lib.write_bytes(b"")
    lib.with_suffix(".log.json").write_text("{}")
    before = obs_timing.PROCESS.summary()
    assert _build.build() == lib
    after = obs_timing.PROCESS.summary()

    def n(s, k):
        return s.get(k, {}).get("count", 0)
    assert n(after, "kernels.reused") == n(before, "kernels.reused") + 1
    assert n(after, "kernels.build") == n(before, "kernels.build") + 1
    assert n(after, "kernels.built") == n(before, "kernels.built")


def _spans_run(spans, rule_impl="python", calls=1, n=4):
    init, _, meta = th.make_experiment(
        ecfg=th.RSTDPConfig(trial_steps=32), rule_impl=rule_impl,
        device=CPU, spans=spans)
    scanned = th.make_scanned_training(meta)
    stims = th.stimuli(n)
    state = init()
    for k in range(calls):
        draws = meta["draw"](torch.Generator().manual_seed(10 + k), stims)
        state, hist = scanned(state, stims, draws)
    return state, hist, meta


@pytest.mark.parametrize("rule_impl", ["python", "vm"])
def test_scanned_spans_on_off_bit_equal(rule_impl):
    """``make_experiment(spans=True)`` and ``spans=False`` give the same
    states and histories bit for bit over two calls; off records
    nothing."""
    s_on, h_on, m_on = _spans_run(True, rule_impl, calls=2)
    s_off, h_off, m_off = _spans_run(False, rule_impl, calls=2)
    assert sorted(h_on) == sorted(h_off)
    for k in h_on:
        assert torch.equal(h_on[k], h_off[k]), k
    for a, b in zip(th._leaves(s_on), th._leaves(s_off)):
        assert torch.equal(a, b)
    assert m_off["timer"].summary() == {}
    assert m_on["timer"] is m_on["scanned_training"].timer
    assert m_on["timer"].summary()["scan.calls"]["count"] == 2


def test_scanned_spans_count_calls_and_regions():
    """After k calls of n trials: k samples of ``scan.load``,
    ``scan.replays`` and ``scan.clones``, ``scan.calls`` k, one
    ``scan.loop_misses`` for one shape, and the last trial of each call in
    ``trial.emulation`` / ``trial.rule`` / ``trial.carry``, together no
    longer than the call's replays."""
    k = 3
    _, _, meta = _spans_run(True, calls=k, n=4)
    s = meta["timer"].summary()
    for name in ("scan.load", "scan.replays", "scan.clones",
                 *th.TRIAL_REGIONS):
        assert s[name]["count"] == k, name
        assert s[name]["best_us"] > 0, name
    assert s["scan.calls"] == dict(count=k)
    assert s["scan.loop_misses"] == dict(count=1)
    smp = meta["timer"].samples
    for i in range(k):
        last = sum(smp[name][i] for name in th.TRIAL_REGIONS)
        assert last <= smp["scan.replays"][i]
    run_out, _, run_meta = th.run_training(
        2, device=CPU, ecfg=th.RSTDPConfig(trial_steps=32))
    assert run_meta["timer"].summary()["scan.calls"] == dict(count=1)
    assert "spans" not in run_out


@pytest.mark.parametrize("backend", ["fused", "blocked"])
def test_profile_phases_keys(backend):
    cfg = BSS2.reduced()
    core = AnnCore(cfg, ideal_instance(cfg, device=CPU), backend=backend)
    ev, ad = map(t, _events(32, cfg.n_rows))
    s = obs_timing.profile_phases(core, core.init_state(), ev, ad, iters=1)
    assert set(s) >= {"synray", "neuron", "corr", "total"}
    assert all(v["best_us"] > 0 for v in s.values())


def test_profiler_trace(tmp_path):
    with obs_timing.profiler_trace(None):
        pass
    with obs_timing.profiler_trace(str(tmp_path / "tr")):
        torch.ones(8).sum()
    assert json.loads((tmp_path / "tr" / "trace.json").read_text())


def test_report_roundtrip(tmp_path):
    out, _, _ = th.run_training(3, seed=0, device=CPU, telemetry=True,
                                ecfg=th.RSTDPConfig(trial_steps=64))
    rep = obs_report.build_report(
        "unit", telemetry=out["telemetry"],
        timings={"total": dict(count=1, total_us=5.0, mean_us=5.0,
                               best_us=5.0)},
        config=dict(n_trials=3))
    assert rep["telemetry"]["trials"] == 3
    assert rep["torch_version"] == torch.__version__
    assert "jax_backend" not in rep and rep["git_sha"]
    md = obs_report.to_markdown(rep)
    assert "out_spikes" in md and "Phase timings" in md
    paths = obs_report.write_report(rep, str(tmp_path / "r.json"))
    assert json.load(open(paths["json"]))["telemetry"]["trials"] == 3
    assert os.path.exists(paths["md"])


def test_report_warnings_derived():
    tele = dict(overflow_fallbacks=2, census_events_max=999, vm_sat_hits=7)
    rep = obs_report.build_report("w", telemetry=tele)
    assert len(rep["warnings"]) == 2
    joined = " ".join(rep["warnings"])
    assert "overflow" in joined and "saturation" in joined


# ---------------------------------------------------------------------------
# Playback with telemetry
# ---------------------------------------------------------------------------

def test_playback_telemetry_and_compare_traces():
    cfg = BSS2.reduced()
    rng = np.random.default_rng(0)
    T = 48
    ev = (rng.random((T, cfg.n_rows)) < 0.05).astype(np.float32)
    w = rng.integers(0, 40, (cfg.n_rows, cfg.n_cols)).astype(np.int8)
    prog = [pb.write_weights(w), pb.inject(ev), pb.run(16),
            pb.read_rates(), pb.write_ppu_program(programs.stdp_program()),
            pb.ppu_run(), pb.read_weights()]
    fb = pb.FastBackend(cfg, device=CPU, telemetry=True)
    trace = fb.execute(prog)
    s = fb.telemetry_summary()
    assert s["steps"] == T + 16 and s["in_events"] == int(ev.sum())
    assert s["vm_runs"] == 1 and s["trials"] == 1
    assert pb.FastBackend(cfg, device=CPU).telemetry_summary() is None
    trace_off = pb.FastBackend(cfg, device=CPU).execute(prog)
    assert pb.compare_traces(trace, trace_off) == []
    bad = [(tt, k, np.array(v, copy=True)) for tt, k, v in trace_off]
    bad[-1][2].flat[3] += 5
    errs = pb.compare_traces(trace, bad)
    assert errs and "phase ppu" in errs[0] and "index" in errs[0]


@pytest.mark.parametrize("rule", sorted(corpus.GOLDEN_RULES))
def test_golden_traces_unchanged_with_telemetry(rule):
    golden = corpus.load_trace(rule)
    tr = pb.execute(corpus.canonical_program(rule), "fast",
                    corpus.golden_cfg(), device=CPU, telemetry=True)
    assert pb.compare_traces(tr, golden, atol=0.05) == []
    for (tg, kg, vg), (_, _, v) in zip(golden, tr):
        if kg in ("PPU_W", "WEIGHTS"):
            np.testing.assert_array_equal(v.astype(np.int32),
                                          vg.astype(np.int32))
