"""Wafer weak scaling and inter-chip bus throughput on the port.

    python3 benchmarks/torch_wafer_bench.py [--device cpu] [--json FILE]

The port's counterpart of ``benchmarks/wafer_bench.py``, at the full chip
size per chip (256 rows x 512 columns, T = 128):

- Weak scaling: K = 1, 2, 4, 8 chips on the ring topology (one out-link a
  chip, so the routing work per chip is constant), 512 random routes a
  link into the upper half of the receiving chip's rows (relay rows
  storing address 7, so routed events conduct; the lower half keeps the
  external events), the same external events (density 0.05) on every
  chip, ``backend="blocked"``, ``link_mode="auto"``: W = 4 windows of
  ``run_windows`` timed together (CUDA events, median of 6 after a
  warm-up), in microseconds a window, against K = 1. On one card the K
  chips are one instance prefix, so the emulation's work grows with K;
  the rung shows what the router adds on top.
- Bus throughput: routed events a second through ``route()`` alone
  (telemetry on, which takes the link census): four chips, all2all with
  full fan-out (every column of every chip routed to every chip, 8,192
  routes), spikes of density 0.5, ``link_budget=T*R`` and no step budget,
  in every link mode; against the ~0.4 M events/s software event-bus
  budget that the reference's bench quotes from the paper (Fig. 8).

Each number is printed beside the card's name and power limit. With
``--device cpu`` it runs on the host clock, which is no device
measurement. Exits non-zero without a card unless ``--device cpu`` is
given.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
REPEATS = 6
CHIPS = (1, 2, 4, 8)
R, C, T, W = 256, 512, 128, 4
ROUTES_PER_LINK = 512
BUS_BUDGET = 0.4e6          # events/s, the paper's software event bus


def _timed(fn, device):
    """Median and best of ``REPEATS`` timings of ``fn`` in ms, after one
    warm-up call: CUDA events on a card, the host clock on the CPU."""
    import torch
    fn()
    times = []
    for _ in range(REPEATS):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2], times[0]


def _ring(K, rng):
    from repro_torch.wafer import WaferTopology, make_plan
    routes = [(s, int(rng.integers(C)), (s + 1) % K,
               int(rng.integers(R // 2, R)), 7)
              for s in range(K) for _ in range(ROUTES_PER_LINK)]
    return make_plan(WaferTopology(K, "ring"), R, C, routes)


def run(device):
    import numpy as np
    import torch
    from repro_torch.configs.bss2 import BSS2
    from repro_torch.core.anncore import AnnCore
    from repro_torch.obs import trace as obs_trace
    from repro_torch.verif.mismatch import sample_instance
    from repro_torch.wafer import (InterChipRouter, WaferTopology, make_plan,
                                   run_windows)
    rng = np.random.default_rng(0)
    ev1 = torch.from_numpy((rng.random((W, T, 1, R)) < 0.05).astype(
        np.float32))
    scaling = []
    for K in CHIPS:
        plan = _ring(K, rng)
        inst = sample_instance(BSS2, torch.Generator().manual_seed(3), (K,),
                               device=device)
        core = AnnCore(BSS2, inst, backend="blocked")
        router = InterChipRouter(plan, device=device)
        a = torch.zeros((K, R, C), dtype=torch.int8)
        a[torch.from_numpy(plan.relay_rows())] = 7
        st = core.init_state((K,))
        st = st._replace(syn=st.syn._replace(
            weights=torch.from_numpy(rng.integers(
                20, 60, (K, R, C)).astype(np.int8)).to(device),
            addresses=a.to(device)))
        ev = ev1.expand(W, T, K, R).contiguous().to(device)
        ad = torch.zeros((W, T, K, R), dtype=torch.int8, device=device)
        res = {}

        def windows():
            res["out"] = run_windows(core, router, st, ev, ad,
                                     telemetry=obs_trace.init_telemetry(
                                         device))[1]
        med, best = _timed(windows, device)
        tele = obs_trace.summary(res["out"]["telemetry"])
        scaling.append(dict(
            n_chips=K, us_per_window=1e3 * med / W,
            best_us_per_window=1e3 * best / W,
            routed_events=tele["routed_events"],
            routed_events_per_s=tele["routed_events"] / (med * 1e-3),
            link_overflows=tele["link_overflows"],
            spikes=float(res["out"]["spikes"].sum())))
        row = scaling[-1]
        print(f"K={K}: {row['us_per_window']:9.1f} us/window (best "
              f"{row['best_us_per_window']:.1f}), {row['routed_events']} "
              f"routed, {row['routed_events_per_s'] / 1e6:.3f} M events/s "
              f"in the emulation", flush=True)
    base = scaling[0]["us_per_window"]
    for row in scaling:
        row["weak_scaling_vs_k1"] = row["us_per_window"] / base

    # the router alone: full fan-out all2all, busy spikes
    K = 4
    plan = make_plan(WaferTopology(K, "all2all"), R, C,
                     [(s, c, d, (c * K + s + d) % R, 7) for s in range(K)
                      for d in range(K) for c in range(C)])
    sp = torch.from_numpy((rng.random((T, K, C)) < 0.5).astype(
        np.float32)).to(device)
    bus = {}
    for mode in ("compact", "dense", "auto"):
        router = InterChipRouter(plan, device=device, link_mode=mode,
                                 link_budget=T * R, link_step_budget=R)
        res = {}

        def route():
            res["tele"] = router.route(
                sp, obs_trace.init_telemetry(device))[1]
        med, best = _timed(route, device)
        n = obs_trace.summary(res["tele"])["routed_events"]
        bus[mode] = dict(ms=med, best_ms=best, routed_events=n,
                         events_per_s=n / (med * 1e-3),
                         budget_ratio=n / (med * 1e-3) / BUS_BUDGET)
        print(f"router alone ({mode}): {n} routed events in {med:.4f} ms "
              f"-> {bus[mode]['events_per_s'] / 1e6:.1f} M events/s "
              f"({bus[mode]['budget_ratio']:.0f}x the 0.4 M events/s bus "
              f"budget)", flush=True)
    return dict(weak_scaling=scaling, router=bus,
                paper_bus_budget_events_per_s=BUS_BUDGET)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--json", default=None, metavar="FILE")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch import resolve_device
    device = resolve_device(args.device)
    card = None
    if device.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        print(card)
    res = dict(device=str(device), card=card, **run(device))
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
