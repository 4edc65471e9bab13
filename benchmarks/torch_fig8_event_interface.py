"""Paper Fig. 8 (adapted) on the port: event-interface integrity.

    python3 benchmarks/torch_fig8_event_interface.py [--device cpu]
                                                     [--json FILE]

The counterpart of ``benchmarks/fig8_event_interface.py``. The silicon
constrains the event bus to a <= 150 ps skew window so that events latch
identically on every lane; the software analogue is that the event path
routes spikes identically across backends and across batch lanes, and its
throughput is a first-class number:

- Routing equality on random address patterns (addresses 0..63, so most
  events match no synapse): the ``synray`` kernel against its plain
  version on a [T=16, 16 lanes, R=256] x [256, 512] window (max |dev|,
  within 1e-4), and every lane run alone equal bit for bit to its lane
  of the batched call (the skew-window check: no lane sees another's
  events).
- Events a second through the whole-window path at [T=128, R=256,
  C=512] and rates 0.001 ... 0.5: dense (``synray``) and event-sparse
  (``synray_sparse``, capacities sized for the window), CUDA-event
  medians of 10 after a warm-up; the paper budgets the software event
  bus at ~0.4 M events/s.

Each number is printed beside the card's name and power limit. With
``--device cpu`` the host clock, which is no device measurement. Exits
non-zero without a card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
R, C, B = 256, 512, 16
RATES = (0.001, 0.01, 0.05, 0.1, 0.5)
BUS_BUDGET = 0.4e6


def _timed(fn, device, reps=10):
    import torch
    fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            torch.cuda._sleep(1_000_000)
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
    return times[len(times) // 2]


def routing_equality(device):
    import torch
    from repro_torch.kernels.synray import ops as synray_ops
    from repro_torch.kernels.synray.ref import synaptic_current_ref
    gen = torch.Generator().manual_seed(0)
    T = 16
    ev = (torch.rand((T, B, R), generator=gen) < 0.1).to(
        torch.float32).to(device)
    ea = torch.randint(0, 64, (T, B, R), generator=gen,
                       dtype=torch.int8).to(device)
    w = torch.randint(0, 64, (R, C), generator=gen, dtype=torch.int8)
    st = torch.randint(0, 64, (R, C), generator=gen, dtype=torch.int8)
    w, st = (x.expand(B, R, C).contiguous().to(device) for x in (w, st))
    got = synray_ops.synaptic_current(ev, ea, w, st)
    want = synaptic_current_ref(ev, ea, w, st)
    max_dev = float((got - want).abs().max())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    lanes_equal = all(torch.equal(
        synray_ops.synaptic_current(ev[:, i:i + 1], ea[:, i:i + 1],
                                    w[i:i + 1], st[i:i + 1])[:, 0],
        got[:, i]) for i in range(B))
    if not lanes_equal:
        raise AssertionError("a lane run alone differs from its lane of "
                             "the batched call")
    matches = (st.unsqueeze(0) == ea.unsqueeze(-1)) & (ev != 0).unsqueeze(-1)
    print(f"cross-backend routing deviation (kernel vs plain, skew-window "
          f"analogue): {max_dev:.2e} (within 1e-4); {B} lanes alone == "
          f"batched bit for bit; {int(ev.sum())} events, "
          f"{int(matches.sum())} address matches", flush=True)
    return dict(max_dev=max_dev, lanes_equal=lanes_equal)


def rate_sweep(device):
    import torch
    from repro_torch.core import events, synapse
    gen = torch.Generator().manual_seed(1)
    T = 128
    w = torch.randint(0, 64, (1, R, C), generator=gen,
                      dtype=torch.int8).to(device)
    a = torch.randint(0, 64, (1, R, C), generator=gen,
                      dtype=torch.int8).to(device)
    rows = []
    for rate in RATES:
        fired = torch.rand((T, 1, R), generator=gen) < rate
        ev = torch.where(fired, 0.1 + 1.4 * torch.rand(
            (T, 1, R), generator=gen), 0.0).to(device)
        ad = torch.randint(0, 64, (T, 1, R), generator=gen,
                           dtype=torch.int8).to(device)
        n, kmax = (int(x) for x in events.window_stats(ev))
        E = max(32, ((n + 7) // 8) * 8)
        K = max(8, ((kmax + 3) // 4) * 4)
        td = _timed(lambda: synapse.synaptic_current_window(
            w, a, ev, ad, 1.0, sparse="never"), device)
        ts = _timed(lambda: synapse.synaptic_current_window(
            w, a, ev, ad, 1.0, sparse="always", max_events=E, k_cap=K),
            device)
        rows.append(dict(rate=rate, n_events=n, dense_ms=td, sparse_ms=ts,
                         dense_events_per_s=n / (td * 1e-3),
                         sparse_events_per_s=n / (ts * 1e-3)))
    print(f"# events a second through the window path [T={T}, {R}x{C}]")
    for s in rows:
        print(f"  rate={s['rate']:<6g} n={s['n_events']:<6d} dense "
              f"{s['dense_ms']:.4f} ms {s['dense_events_per_s'] / 1e6:9.2f} "
              f"M ev/s   sparse {s['sparse_ms']:.4f} ms "
              f"{s['sparse_events_per_s'] / 1e6:9.2f} M ev/s "
              f"({s['sparse_events_per_s'] / BUS_BUDGET:.0f}x the 0.4 M "
              f"events/s bus budget)", flush=True)
    return rows


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
    print("# Fig. 8 adaptation on the port: event-interface integrity")
    res = dict(device=str(device), card=card,
               routing=routing_equality(device), rate_sweep=rate_sweep(
                   device), paper_bus_budget_events_per_s=BUS_BUDGET)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
