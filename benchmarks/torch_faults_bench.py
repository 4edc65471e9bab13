"""Defect tolerance of the §5 loop and link failover on the port.

    python3 benchmarks/torch_faults_bench.py [--device cpu] [--json FILE]

The port's counterpart of ``benchmarks/faults_bench.py``, both rungs:

1. Fault-rate sweep, at the reference's §5 cell (32 x 16, 150 trials,
   seed 1, the reference's rates and sampling): per rate, the trailing
   mean reward (last 45 trials) of the naive run over all columns and of
   the screened run (faults under the blacklist ``screen`` finds) over
   the healthy columns, against the clean run; the screening time (CUDA
   events on a card) and the telemetry fault gauges. The cell stays at
   the reference's size because the claim is the learning curve's.
2. Link failover at the full chip size: four 256 x 512 chips on all2all,
   each announcing its first 32 columns to every chip on rows of their
   own; link (0, 2) dead and blacklisted, the plan rerouted over the
   forwards ``reroute_plan`` emits; three windows of busy spikes (density
   0.5) routed with the forwards fed back: forwarded events
   (``link_reroutes``), routed events, and ``route()``'s time with the
   forwards against the clean plan's.

Each time is printed beside the card's name and power limit. With
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
N_TRIALS = 150
TAIL = 45
RATES = (0.0, 0.06, 0.12, 0.25)


def _trailing(out, cols=slice(None)):
    import numpy as np
    return float(np.mean(out["mean_reward"][-TAIL:, cols]))


def _ms(fn, device):
    """(ms, result) of one call: CUDA events on a card, else the host
    clock."""
    import torch
    if device.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return (time.perf_counter() - t0) * 1e3, out
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b), out


def sweep(device):
    import numpy as np
    from repro_torch.core.hybrid import run_training
    from repro_torch.faults import sample_fault_plan, screen
    out_clean, _, _ = run_training(n_trials=N_TRIALS, seed=1, device=device)
    clean = _trailing(out_clean)
    print(f"clean baseline: {clean:.4f} trailing mean reward", flush=True)
    rows = []
    for rate in RATES:
        rng = np.random.default_rng(7)
        fp = (sample_fault_plan(32, 16, rng, p_dead_row=rate / 2,
                                p_hot_neuron=rate, p_cadc=rate, seed=1)
              if rate > 0 else None)
        row = dict(rate=rate, sites=0 if fp is None else fp.total_sites,
                   clean=clean)
        out_f, _, meta = run_training(n_trials=N_TRIALS, seed=1,
                                      device=device, faults=fp)
        row["naive"] = _trailing(out_f)
        screen(meta["core"], meta["ppu"])                   # warm-up
        row["screen_ms"], bl = _ms(lambda: screen(meta["core"], meta["ppu"]),
                                   device)
        row["blacklisted_rows"] = bl.n_rows
        row["blacklisted_neurons"] = bl.n_neurons
        out_b, _, _ = run_training(n_trials=N_TRIALS, seed=1, device=device,
                                   faults=fp, blacklist=bl, telemetry=True)
        healthy = ~bl.neurons
        row["screened"] = (_trailing(out_b, healthy) if healthy.any()
                           else float("nan"))
        tl = out_b["telemetry"]
        row["faults_injected"] = tl["faults_injected"]
        row["faults_detected"] = tl["faults_detected"]
        rows.append(row)
        print(f"rate={rate:5.2f}: {row['sites']:3d} sites, naive "
              f"{row['naive']:.4f}, screened {row['screened']:.4f} "
              f"(blacklist {bl.n_rows} rows / {bl.n_neurons} neurons, screen "
              f"{row['screen_ms']:.1f} ms)", flush=True)
    return rows


def failover(device):
    import numpy as np
    import torch
    from repro_torch.faults import FaultPlan
    from repro_torch.obs import trace as obs_trace
    from repro_torch.wafer import (InterChipRouter, WaferTopology, make_plan,
                                   reroute_plan)
    K, R, C, T = 4, 256, 512, 128
    plan = make_plan(WaferTopology(K, "all2all"), R, C,
                     [(s, c, d, 32 * s + c, 63) for s in range(K)
                      for d in range(K) for c in range(32)])
    links = plan.topology.links()
    dead = (0, 2)
    p2, n_re = reroute_plan(plan, [dead])
    fp = FaultPlan(dead_links=np.array([sd == dead for sd in links]))
    router = InterChipRouter(p2, device=device, faults=fp)
    clean = InterChipRouter(plan, device=device)
    sp = (torch.rand((T, K, C), generator=torch.Generator().manual_seed(0))
          < 0.5).to(torch.float32).to(device)
    tele = obs_trace.init_telemetry(device)
    routed = router.init_buffer(T)
    for _ in range(3):
        routed, tele = router.route(sp, tele, routed_in=routed)
    s = obs_trace.summary(tele)
    if not (s["link_reroutes"] > 0 and s["routed_events"] > 0):
        raise AssertionError(f"failover: counters {s}")
    router.route(sp, routed_in=routed)
    clean.route(sp)
    ms_f = min(_ms(lambda: router.route(sp, routed_in=routed), device)[0]
               for _ in range(6))
    ms_c = min(_ms(lambda: clean.route(sp), device)[0] for _ in range(6))
    row = dict(dead_link=list(dead), rerouted_routes=n_re,
               forward_rules=int(p2.n_forwards),
               link_reroutes=s["link_reroutes"],
               routed_events=s["routed_events"], route_ms_failover=ms_f,
               route_ms_clean=ms_c)
    print(f"failover: link {dead} dead -> {n_re} routes re-homed over "
          f"{p2.n_forwards} forward rules, {s['link_reroutes']} events "
          f"forwarded / {s['routed_events']} routed in 3 windows; route() "
          f"{ms_f:.4f} ms with the forwards, {ms_c:.4f} ms clean (best of "
          f"6)", flush=True)
    return row


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
    res = dict(device=str(device), card=card, sweep=sweep(device),
               failover=failover(device))
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
