"""One rank of the sharded-transport check (``tests/test_torch_wafer_
sharded.py`` starts two of them): ``python _torch_wafer_sharded.py RANK
WORLD STORE_FILE [gloo|nccl] [transport|gaps|path_f]``.

Each rank joins a process group through a file store (gloo on the CPU,
the default; nccl on card ``RANK``, one card a rank), holds chips
``[rank K/WORLD, (rank+1) K/WORLD)`` of a K = 4 wafer, and runs the same
routed windows as the local transport on every chip (which it runs too):
its spikes, delivered grids and link counters must equal the local
run's slice bit for bit. Last, a mapped network (``repro_torch.mapper``)
through ``build_runtime(group=)``: its windows run through the rank's
window loop (replays of one captured window on a card, the sharded
transport's collectives inside the graph), equal to the local runtime's
slice, to its own eager windows and, on a second stimulus, to a fresh
runtime. The ``gaps`` part runs what the reference takes with its
``ctx`` / ``wafer_ctx``: a mapped network with dead rows, a hot neuron
and a dead link through ``build_runtime(group=, faults=)``, and
``run_training(wafer=4, group=)`` (clean and faulted; on a card one
captured trial graph with the collectives inside), each equal to the
local transport's slice. The ``path_f`` part (a card a rank, world 1, 2
or 4) runs path F's 480 x 2048 network on four full chips under the
group (``path_f``): replays against eager windows, against the local
runtime and against one chip, timed; it prints one ``PATH_F_GROUPED``
JSON line. Not collected by pytest (no ``test_`` prefix).
"""
import dataclasses
import gc
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs.bss2 import BSS2  # noqa: E402
from repro_torch.core.anncore import AnnCore  # noqa: E402
from repro_torch.core.graph import leaves  # noqa: E402
from repro_torch.core.hybrid import run_training, stimuli  # noqa: E402
from repro_torch.faults import FaultPlan, screen_links  # noqa: E402
from repro_torch.mapper import (build_runtime, map_network,  # noqa: E402
                                random_spec, sample_network_instance)
from repro_torch.obs import trace as obs  # noqa: E402
from repro_torch.verif.mismatch import sample_instance  # noqa: E402
from repro_torch.wafer import (InterChipRouter, WaferTopology,  # noqa: E402
                               make_plan, reroute_plan, run_windows,
                               s5_column_plan)

K, R, C, T, W = 4, 16, 8, 32, 3
COUNTERS = ("routed_events", "link_overflows", "link_events_max",
            "link_reroutes", "faults_injected")


def ring_mask(n):
    """Recurrent edges from quarter q to quarter q + 1 (q = 1, 3): they
    cross a chip boundary of a K = 4 ring, so it maps without relays."""
    q = n // 4
    mask = np.zeros((n, n), bool)
    for s in (1, 3):
        d = (s + 1) % 4
        mask[s * q:(s + 1) * q, d * q:(d + 1) * q] = True
    return mask


def counters(tele):
    s = obs.summary(tele)
    return {k: s[k] for k in COUNTERS}


def _mapping(topology):
    """``(mapping, spec)``: a 16 -> 32 random spec with ring-crossing
    recurrence on four 64 x 8 chips."""
    n = 32
    spec = random_spec(np.random.default_rng(7), 16, n, fan_out=4,
                       rec_fan_out=3, rec_mask=ring_mask(n))
    return map_network(spec, K, chip_rows=64, chip_cols=n // K,
                       topology=topology), spec


def _stimulus(seed, dev):
    return torch.from_numpy((np.random.default_rng(seed).random(
        (W, T, 16)) < 0.3).astype(np.float32)).to(dev)


def same_run(a, b, what):
    """Two ``run`` results bit for bit: state, spikes, per-chip planes,
    routed grid and counters."""
    (s_a, o_a), (s_b, o_b) = a, b
    for i, (x, y) in enumerate(zip(leaves(s_a), leaves(s_b))):
        assert torch.equal(x, y), (what, "state", i)
    for k in ("spikes", "chip_spikes", "routed"):
        assert torch.equal(o_a[k], o_b[k]), (what, k)
    assert counters(o_a["telemetry"]) == counters(o_b["telemetry"]), \
        (what, counters(o_a["telemetry"]), counters(o_b["telemetry"]))


def mapped(group, chips, dev):
    """A mapped network through ``build_runtime(group=)``, ring and
    all2all: each rank runs its chips through its window loop (one loop on
    each runtime), the spec-order spikes (gathered over the group) equal
    the local runtime's and its chips' planes the local planes' slice;
    with counters, the loop equals the rank's eager windows
    (``eager=True``); a second stimulus through the same loop equals a
    fresh runtime's run."""
    checked = 0
    for topology in ("ring", "all2all"):
        m, spec = _mapping(topology)
        net_inst = sample_network_instance(
            spec, torch.Generator().manual_seed(9), device=dev)
        ev_in = _stimulus(8, dev)
        loc_rt = build_runtime(m, net_inst=net_inst, device=dev)
        _, loc = loc_rt.run(ev_in)
        sh_rt = build_runtime(m, net_inst=net_inst, device=dev, group=group)
        _, sh = sh_rt.run(ev_in)
        assert len(loc_rt.loops) == 1 and len(sh_rt.loops) == 1, topology
        assert torch.equal(sh["spikes"], loc["spikes"]), topology
        assert torch.equal(sh["chip_spikes"],
                           loc["chip_spikes"][:, :, chips]), topology
        assert torch.equal(sh["routed"], loc["routed"][:, chips]), topology
        assert loc["spikes"].sum() > 0 and loc["routed"].sum() > 0
        checked += 1

        # the loop against the rank's eager windows, with counters
        replayed, eager = (sh_rt.run(ev_in, telemetry=obs.init_telemetry(
            dev), eager=e) for e in (False, True))
        assert len(sh_rt.loops) == 2, topology
        same_run(replayed, eager, (topology, "loop vs eager"))
        assert counters(replayed[1]["telemetry"])["routed_events"] > 0
        checked += 1

        # another stimulus through the same loops, against a fresh runtime
        ev2 = _stimulus(18, dev)
        again = sh_rt.run(ev2, telemetry=obs.init_telemetry(dev))
        fresh = build_runtime(m, net_inst=net_inst, device=dev,
                              group=group).run(
            ev2, telemetry=obs.init_telemetry(dev))
        assert len(sh_rt.loops) == 2, topology
        same_run(again, fresh, (topology, "second run vs fresh"))
        assert not torch.equal(again[1]["spikes"], replayed[1]["spikes"])
        checked += 1
    return checked


def mapped_with_faults(group, chips, dev):
    """``build_runtime(group=, faults=)`` against the local runtime with
    the same plan: dead rows and a hot neuron on two chips' planes, a dead
    link that carries traffic. Spikes, routed grids and link counters
    equal; the plan changes the run."""
    checked = 0
    for topology in ("ring", "all2all"):
        m, spec = _mapping(topology)
        n = spec.n_neurons
        net_inst = sample_network_instance(
            spec, torch.Generator().manual_seed(9), device=dev)
        ev_in = _stimulus(8, dev)
        _, clean = build_runtime(m, net_inst=net_inst, device=dev).run(ev_in)
        busy = clean["routed"].sum(dim=(0, 2))     # events a chip gets
        dst = int(torch.argmax(busy))
        links = m.plan.topology.links()
        dead = np.array([d == dst and s != dst for s, d in links])
        dead_rows = np.zeros((K, 64), bool)
        dead_rows[1, :3] = True
        dead_rows[2, 5] = True
        hot = np.zeros((K, n // K), bool)
        hot[3, 2] = True
        fp = FaultPlan(dead_rows=dead_rows, hot_neurons=hot,
                       dead_links=dead)
        _, loc = build_runtime(m, net_inst=net_inst, device=dev, faults=fp,
                               telemetry=True).run(ev_in)
        sh_rt = build_runtime(m, net_inst=net_inst, device=dev, faults=fp,
                              telemetry=True, group=group)
        sh_st, sh = sh_rt.run(ev_in)
        assert len(sh_rt.loops) == 1, topology
        assert torch.equal(sh["spikes"], loc["spikes"]), topology
        assert torch.equal(sh["chip_spikes"],
                           loc["chip_spikes"][:, :, chips]), topology
        assert torch.equal(sh["routed"], loc["routed"][:, chips]), topology
        assert counters(sh["telemetry"]) == counters(loc["telemetry"]), \
            (topology, counters(sh["telemetry"]), counters(loc["telemetry"]))
        assert not torch.equal(loc["spikes"], clean["spikes"]), topology
        assert not torch.equal(loc["routed"], clean["routed"]), topology
        assert counters(loc["telemetry"])["faults_injected"] == \
            fp.total_sites
        checked += 1
        # the faulted loop against the rank's eager windows
        same_run((sh_st, sh), sh_rt.run(ev_in, eager=True),
                 (topology, "faulted loop vs eager"))
        checked += 1
    return checked


def training(group, chips, dev):
    """``run_training(wafer=4, group=)`` for 6 trials against the local
    transport, clean and with a fault plan: each rank's weights, rewards,
    rates and routed grid equal the local run's slice."""
    checked = 0
    plans = [None]
    links = s5_column_plan(K, 16, 16).topology.links()
    dead_rows = np.zeros((K, 32), bool)
    dead_rows[2, 4:8] = True
    hot = np.zeros((K, 4), bool)
    hot[1, 1] = True
    plans.append(FaultPlan(dead_rows=dead_rows, hot_neurons=hot,
                           dead_links=np.array([sd == (1, 2)
                                                for sd in links])))
    for fp in plans:
        kw = dict(n_trials=6, seed=3, wafer=4, device=dev, faults=fp)
        loc, st_loc, _ = run_training(**kw)
        sh, st_sh, meta = run_training(group=group, **kw)
        assert meta["chips"] == chips
        assert np.array_equal(sh["w_signed_final"],
                              loc["w_signed_final"][chips])
        for k in ("reward", "rates", "w", "mean_reward"):
            assert np.array_equal(sh[k], loc[k][:, chips]), k
        assert torch.equal(st_sh.routed, st_loc.routed[:, chips])
        assert st_loc.routed.sum() > 0
        if fp is None:
            # the rank's draws from meta["draw"] go back in as they are
            d = meta["draw"](torch.Generator().manual_seed(4), stimuli(6))
            again, _, _ = run_training(group=group, draws=d, **kw)
            assert np.array_equal(again["w_signed_final"],
                                  sh["w_signed_final"])
        checked += 1
    try:
        run_training(n_trials=1, device=dev, group=group)
    except ValueError as e:
        assert "wafer=K" in str(e)
    else:
        raise AssertionError("a group without a wafer was taken")
    return checked


def _replays_traced(graph, n=3):
    """``torch.profiler`` over ``n`` bare replays of ``graph`` (at most
    its loop's windows): the device operations a replay (kernels, copies
    and sets: the tracer reports a graph's copy node as a copy or as a
    ``memcpy32_post`` kernel, so only the sum is stable), its kernels and
    NCCL's among them, and the device's busy share of the traced span;
    ``None`` where the trace holds no device kernel."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    n = min(n, graph.loop.n)
    graph.loop.reset()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            graph.replay()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e)
                 for e in events if e.get("ph") == "X" and "dur" in e
                 and str(e.get("cat", "")).lower() in
                 ("kernel", "gpu_memcpy", "gpu_memset"))
    kern = [e for *_, e in dev if str(e.get("cat", "")).lower() == "kernel"]
    if not kern:
        return None
    busy, end = 0.0, None
    for a, b, _ in dev:
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    return dict(ops=len(dev) / n, kernels=len(kern) / n,
                nccl=sum("nccl" in e["name"].lower() for e in kern) / n,
                busy_share=busy / (dev[-1][1] - dev[0][0]))


def _path_f_times(rt_g, rt_loc, ev, graph, turns):
    """ms a window (CUDA events on this rank's card, medians of ``turns``
    runs of each in turns): ``rt.run`` replayed and eager under the group,
    the local runtime's ``rt.run`` replayed, and the group's W replays
    alone, each loop captured before. Every rank runs the same calls in
    the same order."""
    W = ev.shape[0]

    def timed(fn):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / W

    def replays():
        for _ in range(W):
            graph.replay()
    runs = (("replayed", lambda: rt_g.run(ev)),
            ("eager", lambda: rt_g.run(ev, eager=True)),
            ("local_replayed", lambda: rt_loc.run(ev)))
    times = {k: [] for k, _ in runs}
    times["replays_alone"] = []
    for i in range(turns):
        for k, fn in (runs if i % 2 == 0 else runs[::-1]):
            times[k].append(timed(fn))
        graph.loop.reset()
        times["replays_alone"].append(timed(replays))
    return {k: dict(median=float(np.median(v)), runs=v)
            for k, v in times.items()}


def path_f(group, chips, dev, W=6, turns=4):
    """Path F's 480 x 2048 spec on four native 256 x 512 chips under the
    group, W windows of T = 128 (``tests/_torch_mapper.py``), on a card:

    - the window is captured under ``set_sync_debug_mode("error")`` (the
      body is entered twice: warm-up and capture), and ``run``'s replays
      equal the rank's eager windows bit for bit, with counters and route
      counts, a replay launching what an eager window launches
      (``_torch_mapper.replay_against_eager``);
    - the gathered spikes equal the local K = 4 runtime's and the one
      968 x 2048 chip's, the rank's planes, routed grid and counters the
      local run's slice;
    - timed (``_path_f_times``), a fresh capture timed on the host, and 3
      bare replays traced.

    Returns ``(checks, record)``."""
    import time
    import _torch_mapper
    from repro_torch.configs.bss2 import BSS2
    from repro_torch.core.graph import LoopGraph
    from repro_torch.wafer import WindowLoop
    assert dev.type == "cuda", "path_f replays captured windows: a card"
    spec = _torch_mapper.path_f_spec()
    maps = _torch_mapper.path_f_mappings(spec)
    ni = sample_network_instance(spec, torch.Generator().manual_seed(31),
                                 cfg=BSS2, device=dev)
    ev = torch.from_numpy((np.random.default_rng(13).random(
        (W, 128, spec.n_in)) < 0.05).astype(np.float32)).to(dev)
    rt_g = build_runtime(maps[4], cfg=BSS2, net_inst=ni, device=dev,
                         group=group)
    rt_loc = build_runtime(maps[4], cfg=BSS2, net_inst=ni, device=dev)
    rt_1 = build_runtime(maps[1], cfg=BSS2, net_inst=ni, device=dev)

    modes = []
    real = rt_g.core.run_routed

    def run_routed(*args, **kw):
        modes.append(torch.cuda.get_sync_debug_mode())
        return real(*args, **kw)
    before = torch.cuda.get_sync_debug_mode()
    rt_g.core.run_routed = run_routed
    try:
        graph, differ, out, routes, per_window = \
            _torch_mapper.replay_against_eager(rt_g, ev)
    finally:
        del rt_g.core.run_routed
    assert modes == [before, 2] + [before] * W, modes
    assert graph is not None and not differ, differ
    assert out["spikes"].sum() > 0 and out["routed"].sum() > 0
    assert sum(routes) == 2 * W, routes

    loc = rt_loc.run(ev, telemetry=obs.init_telemetry(dev))[1]
    one = rt_1.run(ev)[1]
    assert torch.equal(out["spikes"], loc["spikes"])
    assert torch.equal(out["spikes"], one["spikes"])
    assert torch.equal(out["chip_spikes"], loc["chip_spikes"][:, :, chips])
    assert torch.equal(out["routed"], loc["routed"][:, chips])
    assert counters(out["telemetry"]) == counters(loc["telemetry"]), \
        (counters(out["telemetry"]), counters(loc["telemetry"]))

    rt_g.run(ev)                    # the loops the timed runs replay
    rt_loc.run(ev)
    graph_off = rt_g.loops[(W, 128, False)][1]
    times = _path_f_times(rt_g, rt_loc, ev, graph_off, turns)
    place = rt_g.place(ev)
    loop = WindowLoop(rt_g.core, rt_g.router, rt_g.init_state(), *place)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh = LoopGraph(loop)
    torch.cuda.synchronize()
    capture_ms = (time.perf_counter() - t0) * 1e3
    rec = dict(world=rt_g.router.dp, rank=rt_g.router.rank,
               chips=[chips.start, chips.stop], W=W, T=128,
               device=torch.cuda.get_device_name(dev),
               ms_a_window=times, capture_ms=capture_ms,
               pool_mib=fresh.pool_bytes / 2**20,
               launches_a_replay=graph_off.launches, routes=routes,
               spikes=float(out["spikes"].sum()),
               routed_events=counters(out["telemetry"])["routed_events"],
               trace=_replays_traced(graph_off))
    return 4, rec


def transport(group, chips, dev):
    """The router's sharded transport against the local one (every link
    mode, ring and all2all, link faults and forwards, the link screen),
    then ``mapped``; a group that does not divide K raises."""
    cfg = dataclasses.replace(BSS2.reduced(), n_rows=R, n_cols=C)
    inst = sample_instance(cfg, torch.Generator().manual_seed(3), (K,),
                           device=dev)
    inst_loc = {k: v[chips] for k, v in inst.items() if k != "neuron_params"}
    inst_loc["neuron_params"] = {k: v[chips] for k, v in
                                 inst["neuron_params"].items()}
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.integers(20, 60, (K, R, C)).astype(
        np.int8)).to(dev)
    ev = torch.from_numpy((rng.random((W, T, K, R)) < 0.3).astype(
        np.float32)).to(dev)
    ad = torch.zeros((W, T, K, R), dtype=torch.int8, device=dev)
    checked = 0

    def run(core, router, prefix_chips):
        st = core.init_state((w[prefix_chips].shape[0],))
        a = torch.zeros((K, R, C), dtype=torch.int8, device=dev)
        relay = torch.from_numpy(router.plan.relay_rows()).to(dev)
        a[relay] = 7
        st = st._replace(syn=st.syn._replace(weights=w[prefix_chips].clone(),
                                             addresses=a[prefix_chips]))
        _, out = run_windows(core, router, st, ev[:, :, prefix_chips],
                             ad[:, :, prefix_chips],
                             telemetry=obs.init_telemetry(dev))
        return out

    every = slice(0, K)
    for kind in ("ring", "all2all"):
        routes = []
        for s in range(K):
            for d in ([(s + 1) % K] if kind == "ring" else range(K)):
                for _ in range(4):
                    routes.append((s, int(rng.integers(C)), d,
                                   int(rng.integers(R)), 7))
        plan = make_plan(WaferTopology(K, kind), R, C, routes)
        for kw in (dict(link_mode="dense"), dict(link_mode="compact"),
                   dict(link_mode="auto"),
                   dict(link_mode="compact", link_budget=6),
                   dict(link_mode="auto", link_step_budget=1)):
            loc = run(AnnCore(cfg, inst),
                      InterChipRouter(plan, device=dev, **kw), every)
            sh = run(AnnCore(cfg, inst_loc),
                     InterChipRouter(plan, device=dev, group=group, **kw),
                     chips)
            assert torch.equal(sh["spikes"], loc["spikes"][:, :, chips]), \
                (kind, kw)
            assert torch.equal(sh["routed"], loc["routed"][:, chips]), \
                (kind, kw)
            assert counters(sh["telemetry"]) == counters(loc["telemetry"]), \
                (kind, kw, counters(sh["telemetry"]),
                 counters(loc["telemetry"]))
            assert loc["spikes"].sum() > 0
            assert counters(loc["telemetry"])["routed_events"] > 0
            checked += 1

    # link faults and failover forwards (tests/test_faults.py::test_sharded_
    # link_faults_match_local_subprocess)
    plan = s5_column_plan(K, 8, 16)
    links = plan.topology.links()
    p2, _ = reroute_plan(plan, [(0, 2)])
    fp = FaultPlan(dead_links=np.array([sd == (0, 2) for sd in links]),
                   flaky_links=np.where([sd == (1, 3) for sd in links],
                                        np.float32(0.5), np.float32(0.0)),
                   seed=4)
    sp = torch.from_numpy((np.random.default_rng(1).random((16, K, 4))
                           < 0.4).astype(np.float32)).to(dev)
    for kw in (dict(link_mode="auto"), dict(link_mode="compact",
                                            link_budget=20)):
        r_loc = InterChipRouter(p2, device=dev, faults=fp, **kw)
        r_sh = InterChipRouter(p2, device=dev, faults=fp, group=group,
                               **kw)
        t_loc, t_sh = obs.init_telemetry(dev), obs.init_telemetry(dev)
        g_loc, g_sh = r_loc.init_buffer(16), r_sh.init_buffer(16)
        for _ in range(3):
            g_loc, t_loc = r_loc.route(sp, t_loc, routed_in=g_loc)
            g_sh, t_sh = r_sh.route(sp[:, chips], t_sh, routed_in=g_sh)
            assert torch.equal(g_sh, g_loc[:, chips]), kw
        assert counters(t_sh) == counters(t_loc), kw
        assert counters(t_loc)["link_reroutes"] > 0
        checked += 1
    # the link screen of the plan before the reroute finds both links
    found = [screen_links(InterChipRouter(plan, device=dev, faults=fp,
                                          group=g)) for g in (None, group)]
    assert found[0] == found[1] == ((0, 2), (1, 3)), found

    checked += mapped(group, chips, dev)
    try:
        InterChipRouter(make_plan(WaferTopology(3, "ring"), R, C, []),
                        device=dev, group=group)
    except ValueError as e:
        assert "divides the chip count" in str(e)
    else:
        raise AssertionError("a group that does not divide K was taken")
    return checked


def main(rank, world, store, backend="gloo", part="transport"):
    if backend == "nccl":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world)
    group = dist.group.WORLD
    chips = slice(rank * K // world, (rank + 1) * K // world)
    rec = None
    if part == "gaps":
        checked = (mapped_with_faults(group, chips, dev)
                   + training(group, chips, dev))
    elif part == "path_f":
        checked, rec = path_f(group, chips, dev)
    else:
        checked = transport(group, chips, dev)
    # the captured graphs hold NCCL work: they must be gone before the
    # group is destroyed (a live one hangs the teardown)
    gc.collect()
    dist.destroy_process_group()
    if rec is not None:
        print("PATH_F_GROUPED " + json.dumps(rec), flush=True)
    print(f"WAFER_SHARDED_OK rank={rank} cases={checked}", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
