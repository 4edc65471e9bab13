"""``MappedRuntime.run``'s window loop (``wafer.router.WindowLoop``)
against the eager windows (``wafer.router.run_windows``), on the CPU.

On the CPU ``run`` runs the loop's body window by window (on the card it
replays one captured window, ``tests/test_torch_cuda.py``); ``run(...,
eager=True)`` runs ``run_windows``. Both from the same state, stimulus
and counters must give the same bits: spikes (spec order and per chip),
every state leaf, the last routed grid and every telemetry counter.

- K in {1, 2, 4} on the fused and blocked backends (all2all), a ring
  plan with a relayed edge (forward rules), a blacklisted mapping run
  with its bad sites killed by faults, dead and flaky links, and the
  compact link mode over a tight link budget; each with telemetry off,
  on in the core (fresh counters before window 0) and given (counters
  carried in from an earlier run).
- A second run of the same shapes loads its stimulus and state into the
  same loop and equals a fresh runtime's run; ``run`` leaves the state
  passed in as it was; another W builds another loop.
- The loop's own API: no windows, telemetry that does not match the
  loop, a state with other fields, and a capture without a card raise.
"""
import numpy as np
import pytest
import torch

from _torch_mapper import SMALL_CASES, small_runtime
from repro_torch.core.graph import LoopGraph, leaves
from repro_torch.obs import trace as obs_trace
from repro_torch.wafer import WindowLoop, run_windows

CPU = torch.device("cpu")
W, T = 3, 24                # small_runtime's defaults


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def assert_same(a, b, what):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb), what
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and x.shape == y.shape, (what, i)
        assert torch.equal(_bits(x), _bits(y)), (what, i)


def assert_runs_equal(got, want):
    (s_g, o_g), (s_w, o_w) = got, want
    assert_same(s_g, s_w, "state")
    for k in ("spikes", "chip_spikes", "routed"):
        assert_same(o_g[k], o_w[k], k)
    assert (o_g["telemetry"] is None) == (o_w["telemetry"] is None)
    assert_same(o_g["telemetry"], o_w["telemetry"], "telemetry")


def _counters(rt, ev, mode):
    """``telemetry=`` of a run: none, or (``"given"``) the counters of an
    earlier eager run of the stimulus, so they do not start at zero."""
    if mode != "given":
        return None
    _, out = rt.run(ev, telemetry=obs_trace.init_telemetry(CPU),
                    eager=True)
    return out["telemetry"]


@pytest.mark.parametrize("tele", ["off", "core", "given"])
@pytest.mark.parametrize("case", SMALL_CASES)
def test_window_loop_equals_run_windows(case, tele):
    rt, ev = small_runtime(case, telemetry=tele == "core")
    counters = _counters(rt, ev, tele)
    held = None if counters is None else [x.clone()
                                          for x in leaves(counters)]
    state0 = rt.init_state()
    before = [x.clone() for x in leaves(state0)]
    got = rt.run(ev, telemetry=counters, state=state0)
    assert list(rt.loops) == [(W, T, tele != "off")]
    assert rt.loops[(W, T, tele != "off")][1] is None     # no graph here
    want = rt.run(ev, telemetry=counters, state=state0, eager=True)
    assert_runs_equal(got, want)
    assert want[1]["spikes"].sum() > 0, "a silent network proves nothing"
    assert_same(state0, before, "the state passed in")
    if held is not None:
        assert_same(counters, held, "the counters passed in")
    if tele != "off":
        summ = obs_trace.summary(got[1]["telemetry"])
        assert summ["steps"] == W * T * (2 if tele == "given" else 1)
        bites = {"ring_relay": "link_reroutes", "compact": "link_overflows",
                 "link_faults": "faults_injected"}.get(case)
        if bites:
            assert summ[bites] > 0, bites
    # run_windows itself, on the placed inputs
    ev_t, ad_t = rt.place(torch.from_numpy(ev))
    s_r, o_r = run_windows(rt.core, rt.router, state0, ev_t, ad_t,
                           telemetry=counters)
    assert_same(s_r, got[0], "run_windows state")
    assert_same(o_r["spikes"], got[1]["chip_spikes"], "run_windows spikes")


@pytest.mark.parametrize("case", ["k2_fused", "ring_relay", "blacklist"])
def test_second_run_reuses_the_loop(case):
    """A second run of the same shapes, with a new stimulus, goes through
    the same loop and equals a fresh runtime's run; a run from a given
    state equals the eager windows from it and leaves it as it was; a
    different W builds a new loop."""
    rt, ev = small_runtime(case, telemetry=True)
    st1, _ = rt.run(ev)
    loop = rt.loops[(W, T, True)][0]
    _, ev2 = small_runtime(case, telemetry=True, seed=5)
    assert not np.array_equal(ev, ev2)
    second = rt.run(ev2)
    assert list(rt.loops) == [(W, T, True)]
    assert rt.loops[(W, T, True)][0] is loop
    fresh, _ = small_runtime(case, telemetry=True)
    assert_runs_equal(second, fresh.run(ev2))
    before = [x.clone() for x in leaves(st1)]
    assert_runs_equal(rt.run(ev2, state=st1),
                      rt.run(ev2, state=st1, eager=True))
    assert_same(st1, before, "the state passed in")
    assert_runs_equal(rt.run(ev2[:2]), rt.run(ev2[:2], eager=True))
    assert sorted(rt.loops) == [(2, T, True), (W, T, True)]


def test_window_loop_api():
    rt, ev = small_runtime("k2_fused", telemetry=False)
    ev_t, ad_t = rt.place(torch.from_numpy(ev))
    state = rt.init_state()
    with pytest.raises(ValueError, match="no windows"):
        WindowLoop(rt.core, rt.router, state, ev_t[:0], ad_t[:0])
    loop = WindowLoop(rt.core, rt.router, state, ev_t, ad_t)
    for _ in range(W):
        loop.body()
    assert int(loop.step) == W and loop.spikes.shape[0] == W
    s_e, o_e = run_windows(rt.core, rt.router, state, ev_t, ad_t)
    s_l, o_l = loop.result()
    assert_same(s_l, s_e, "state")
    assert_same([o_l["spikes"], o_l["routed"]],
                [o_e["spikes"], o_e["routed"]], "spikes, routed")
    loop.reset()
    assert int(loop.step) == 0 and not loop.routed.any()
    assert_same(loop.state, state, "reset")
    with pytest.raises(ValueError, match="telemetry on"):
        loop.load(state, ev_t, ad_t, obs_trace.init_telemetry(CPU))
    with pytest.raises(ValueError, match="other fields"):
        loop.load(state._replace(stp=None), ev_t, ad_t)
    with pytest.raises(ValueError, match="CUDA device"):
        LoopGraph(loop)
