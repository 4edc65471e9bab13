"""The full-width mapper network of the port's card checks (not collected
by pytest: no ``test_`` prefix; imports no JAX). ``chip_smoke.py``'s path
F, ``tests/test_torch_cuda.py`` and ``benchmarks/torch_mapper_bench.py``
map and run it. Also the small runtimes that hold ``MappedRuntime.run``'s
window loop to the eager windows (``tests/test_torch_mapper_loop.py`` on
the CPU, ``tests/test_torch_cuda.py`` as replays on the card)."""
import numpy as np

from repro_torch import mapper

N_IN, N_NEURONS = 480, 2048


def path_f_spec() -> mapper.NetworkSpec:
    """The shape of ``examples/map_network.py`` scaled to fill four native
    256 x 512 chips: input i drives neurons floor(i * 2048 / 480) + d
    (d < 8, mod 2048) with weight 30 - 3d, and every 8th neuron j
    inhibits j + 1, 5, 9 and 515 (mod 2048; the last lands on the next
    chip) with weight -15: 4,864 edges."""
    w_in = np.zeros((N_IN, N_NEURONS), np.int32)
    for i in range(N_IN):
        for d in range(8):
            w_in[i, ((i * N_NEURONS) // N_IN + d) % N_NEURONS] = 30 - 3 * d
    w_rec = np.zeros((N_NEURONS, N_NEURONS), np.int32)
    for j in range(0, N_NEURONS, 8):
        for o in (1, 5, 9, 515):
            w_rec[j, (j + o) % N_NEURONS] = -15
    return mapper.NetworkSpec(N_IN, N_NEURONS, w_in, w_rec, name="path-f")


def path_f_mappings(spec):
    """K = 4 native 256 x 512 chips (all2all), K = 2 chips of
    ``min_chip_rows`` + 8 rows x 1024 columns (490: Dale halves of 245
    rows), K = 1 chip of ``min_chip_rows`` + 8 rows x 2048 (968)."""
    maps = {4: mapper.map_network(spec, 4, chip_rows=256, chip_cols=512)}
    for K, cols in ((2, 1024), (1, 2048)):
        maps[K] = mapper.map_network(
            spec, K, chip_rows=mapper.min_chip_rows(spec, K, cols) + 8,
            chip_cols=cols)
    return maps


def path_f_blacklist(spec):
    """Path F's spec on four 264 x 528 chips around a blacklist: the spec
    fills the four native chips' columns exactly (2,048 neurons), so a
    neuron blacklist needs spare columns. 5 even and 3 odd rows and 12
    neurons a chip are screened out, and the link (0, 2) is dead (the spec
    routes nothing on it, so no edge is relayed). Returns ``(mapping,
    blacklist, fault plan)``: the plan kills every bad site."""
    from repro_torch.faults import Blacklist, FaultPlan
    from repro_torch.wafer import WaferTopology
    K, R, C = 4, 264, 528
    rng = np.random.default_rng(41)
    rows = np.zeros((K, R), bool)
    neurons = np.zeros((K, C), bool)
    for k in range(K):
        rows[k, 2 * rng.choice(R // 2, 5, replace=False)] = True
        rows[k, 2 * rng.choice(R // 2, 3, replace=False) + 1] = True
        neurons[k, rng.choice(C, 12, replace=False)] = True
    bl = Blacklist(rows=rows, neurons=neurons, links=((0, 2),))
    m = mapper.map_network(spec, K, chip_rows=R, chip_cols=C, blacklist=bl)
    links = WaferTopology(K, "all2all").links()
    fp = FaultPlan(dead_rows=rows, dead_neurons=neurons,
                   dead_links=np.array([sd == (0, 2) for sd in links]))
    return m, bl, fp


# the small runtimes of tests/test_torch_mapper_loop.py (and of the card's
# replay tests)
SMALL_CASES = ("k1_fused", "k2_fused", "k4_fused", "k1_blocked",
               "k2_blocked", "k4_blocked", "ring_relay", "blacklist",
               "link_faults", "compact")


def relay_mapping():
    """``tests/test_torch_mapper.py::_relay_spec`` on a K = 4 ring, with a
    second input on neuron 8: neuron 0 (chip 0) drives neuron 8 (chip 2)
    through one relay row on chip 1 (the plan's one forward rule)."""
    n = 16
    w_rec = np.zeros((n, n), np.int32)
    w_rec[0, 8] = 40
    w_in = np.zeros((2, n), np.int32)
    w_in[0, 0] = 50
    w_in[1, 8] = 30
    m = mapper.map_network(mapper.NetworkSpec(2, n, w_in, w_rec), 4,
                           chip_rows=8, chip_cols=4, topology="ring")
    assert m.plan.n_forwards == 1
    return m


def small_runtime(case, telemetry, seed=0, device="cpu", W=3, T=24,
                  backend=None):
    """``(runtime, [W, T, n_in] float32 stimulus)`` of one of
    ``SMALL_CASES``: ``k<K>_<backend>`` a 20 x 30 random spec on K chips
    (all2all); ``ring_relay`` ``relay_mapping``; ``blacklist`` the spec
    on four 64 x 12 chips around screened rows and neurons, run with them
    killed by faults; ``link_faults`` K = 4 with one used link dead and
    the other used links dropping half their events; ``compact`` K = 2 in
    the compact link mode over a link budget of 6 events. ``backend``
    overrides the case's (``fused`` unless it names one)."""
    import torch
    from repro_torch.faults import Blacklist, FaultPlan
    rng = np.random.default_rng(seed)
    kw = dict(backend=backend or "fused", device=device,
              telemetry=telemetry)
    if case == "ring_relay":
        ev = (rng.random((W, T, 2)) < 0.5).astype(np.float32)
        return mapper.build_runtime(relay_mapping(), **kw), ev
    spec = mapper.random_spec(np.random.default_rng(0), 20, 30, fan_out=4,
                              rec_fan_out=3)
    ev = (rng.random((W, T, 20)) < 0.25).astype(np.float32)
    kw["net_inst"] = mapper.sample_network_instance(
        spec, torch.Generator().manual_seed(3), device=device)
    if case == "blacklist":
        K, R, C = 4, 64, 12
        rows = np.zeros((K, R), bool)
        rows[0, :16] = rows[2, 1::4] = True
        neurons = np.zeros((K, C), bool)
        neurons[1, :3] = neurons[3, -2:] = True
        m = mapper.map_network(spec, K, chip_rows=R, chip_cols=C,
                               blacklist=Blacklist(rows=rows,
                                                   neurons=neurons))
        return mapper.build_runtime(m, faults=FaultPlan(
            dead_rows=rows, dead_neurons=neurons), **kw), ev
    if case.startswith("k"):
        K = int(case[1])
        kw["backend"] = backend or case.split("_")[1]
    else:
        K = 4 if case == "link_faults" else 2
    cols = 30 // K + 2
    m = mapper.map_network(spec, K, chip_rows=mapper.min_chip_rows(
        spec, K, cols) + 8, chip_cols=cols)
    if case == "link_faults":
        links = m.plan.topology.links()
        used = sorted({(s, d) for s, d in zip(m.plan.src_chip.tolist(),
                                              m.plan.dst_chip.tolist())
                       if s != d})
        dead = np.array([sd == used[0] for sd in links])
        flaky = np.array([0.5 if sd in used[1:] else 0.0 for sd in links],
                         np.float32)
        kw["faults"] = FaultPlan(dead_links=dead, flaky_links=flaky, seed=4)
    if case == "compact":
        kw.update(link_mode="compact", link_budget=6)
    return mapper.build_runtime(m, **kw), ev


def replay_against_eager(rt, ev_in):
    """``rt.run`` replayed (its window captured at the first run of the
    shape with counters) and eager (``eager=True``), each from fresh
    telemetry counters with the device's route counter at 0, on a card.
    Returns ``(graph, differ, out, routes, per_window)``: the replays'
    ``LoopGraph``; the names of what the two runs do not give bit for bit
    (``state``, ``spikes``, ``chip_spikes``, ``routed``, ``telemetry``,
    ``routes``, and ``launches`` where a replay launches other kernels
    than an eager window); the replayed run's output and route counts;
    an eager window's launches."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import synapse
    from repro_torch.core.graph import leaves
    from repro_torch.obs import trace as obs_trace
    dev = ev_in.device
    counter = synapse.route_counts(dev)
    W, T = ev_in.shape[:2]
    runs = []
    for eager in (False, True):
        kernels.reset_launches()
        synapse.reset_route_counts()
        st, out = rt.run(ev_in, telemetry=obs_trace.init_telemetry(dev),
                         eager=eager)
        torch.cuda.synchronize()
        runs.append((st, out, counter.tolist(), dict(kernels.LAUNCHES)))
    (s_r, o_r, r_r, _), (s_e, o_e, r_e, n_e) = runs
    graph = rt.loops[(W, T, True)][1]
    per_window = {k: v // W for k, v in n_e.items()}

    def bits(tree):
        return [x.view(torch.int32) if x.dtype == torch.float32 else x
                for x in leaves(tree)]
    pairs = dict(state=(s_r, s_e), telemetry=(o_r["telemetry"],
                                              o_e["telemetry"]))
    pairs.update({k: (o_r[k], o_e[k])
                  for k in ("spikes", "chip_spikes", "routed")})
    differ = [k for k, (a, b) in pairs.items()
              if len(leaves(a)) != len(leaves(b)) or not all(
                  torch.equal(x, y) for x, y in zip(bits(a), bits(b)))]
    if r_r != r_e:
        differ.append("routes")
    if graph.launches != per_window or any(v % W for v in n_e.values()):
        differ.append("launches")
    return graph, differ, o_r, r_r, per_window
