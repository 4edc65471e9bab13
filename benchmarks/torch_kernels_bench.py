"""Dense against event-sparse synaptic windows on the card: the density
sweep and the crossover density.

    python3 benchmarks/torch_kernels_bench.py [--device cpu] [--json FILE]

The port's counterpart of ``benchmarks/kernels_bench.py``'s density sweep
(``_sparse_density_sweep``), on a [T=128, R=256, C=512] window (random
6-bit weights, stored addresses 0..3) of one instance, as the reference
sweeps it, and of the main path's 16 instances: for each event
density p in 0.001 ... 1.0 the events' efficacies drawn in [0.1, 1.5),
and ``core.synapse.synaptic_current_window`` timed three ways with CUDA
events (median of 25 after a warm-up):

- ``dense`` (``sparse="never"``: the ``synray`` kernel);
- ``sparse`` (``sparse="always"``: the ``synray_sparse`` window form,
  its capacities sized for this window's census, as the reference
  sizes them);
- ``auto`` (the default capacities of the threshold, the census gate on
  the device: ``census``, then both route kernels behind its flag).

Four sweeps: event addresses drawn per step (the general form, whose
capacities ``SPARSE_THRESHOLD`` sizes) and constant per row
(``const_addr=True``, ``SPARSE_THRESHOLD_CONST_ADDR``), each at 1 and 16
instances (capacities per instance, the census over the worst). The
crossover is
the lowest density at which dense is at least as fast as sparse; it is
printed beside the port's two thresholds (``core/synapse.py``), which
were calibrated on a TPU and are not changed here. In place of the
reference's TPU VMEM and roofline estimates, each row carries the card's
bound for the window (the larger of the bytes it must move over 3.35 TB/s
and two operations per event and matched column over 67 TFLOP/s, the
count taken from this window's data, as ``chip_smoke.py`` phase 2 counts
it). Sparse and dense results are held equal bit for bit on the card
where the window fits (within 1e-4 on the CPU).

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
T, R, C = 128, 256, 512
DENSITIES = (0.001, 0.005, 0.01, 0.02, 0.05, 0.1, 0.2, 0.5, 1.0)
REPEATS = 25
MEM_BW = 3.35e12        # H100 SXM HBM3, bytes/s
FP32_PEAK = 67e12       # H100 SXM float32 outside the tensor cores


def _timed(fn, device):
    import torch
    fn()
    times = []
    for _ in range(REPEATS):
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


def sweep(device, const_addr, N):
    import torch
    from repro_torch.core import events, synapse
    gen = torch.Generator().manual_seed(1 + int(const_addr))
    w = torch.randint(0, 64, (N, R, C), generator=gen,
                      dtype=torch.int8).to(device)
    a = torch.randint(0, 4, (N, R, C), generator=gen,
                      dtype=torch.int8).to(device)
    rows = []
    for p in DENSITIES:
        fired = torch.rand((T, N, R), generator=gen) < p
        ev = torch.where(fired, 0.1 + 1.4 * torch.rand(
            (T, N, R), generator=gen), 0.0).to(device)
        if const_addr:
            ad = torch.randint(0, 4, (1, N, R), generator=gen,
                               dtype=torch.int8).expand(T, N, R)
        else:
            ad = torch.randint(0, 4, (T, N, R), generator=gen,
                               dtype=torch.int8)
        ad = ad.contiguous().to(device)
        n, kmax = (int(x) for x in events.window_stats(ev))
        E = max(32, ((n + 7) // 8) * 8)
        K = max(8, ((kmax + 3) // 4) * 4)
        kw = dict(const_addr=const_addr)

        def dense():
            return synapse.synaptic_current_window(w, a, ev, ad, 1.0,
                                                   sparse="never", **kw)

        def sparse():
            return synapse.synaptic_current_window(
                w, a, ev, ad, 1.0, sparse="always", max_events=E, k_cap=K,
                **kw)

        def auto():
            return synapse.synaptic_current_window(w, a, ev, ad, 1.0, **kw)
        i_d, i_s = dense(), sparse()
        if device.type == "cuda":
            if not torch.equal(i_d, i_s):
                raise AssertionError(f"p={p}: sparse != dense on the card")
        else:
            torch.testing.assert_close(i_s, i_d, rtol=1e-4, atol=1e-4)
        n_fma = float(sum(
            ((a[i].unsqueeze(0) == ad[:, i].unsqueeze(-1))     # [T, R, C]
             & (ev[:, i] != 0).unsqueeze(-1)).sum() for i in range(N)))
        n_bytes = N * (T * R * 5 + 2 * R * C + T * C * 4)
        t_b, t_o = n_bytes / MEM_BW, 2 * n_fma / FP32_PEAK
        row = dict(density=p, n_events=n, k_max=kmax,
                   dense_ms=_timed(dense, device),
                   sparse_ms=_timed(sparse, device),
                   auto_ms=_timed(auto, device),
                   bound_ms=max(t_b, t_o) * 1e3,
                   bound_by="bytes" if t_b >= t_o else "operations")
        row["speedup"] = row["dense_ms"] / row["sparse_ms"]
        rows.append(row)
        print(f"  p={p:<6g} n={n:<6d} dense {row['dense_ms']:.4f}  sparse "
              f"{row['sparse_ms']:.4f}  auto {row['auto_ms']:.4f} ms  "
              f"bound {row['bound_ms']:.4f} ({row['bound_by']})  dense / "
              f"sparse {row['speedup']:.2f}x", flush=True)
    crossover = next((r["density"] for r in rows if r["speedup"] <= 1.0),
                     1.0)
    return rows, crossover


def run(device):
    from repro_torch.core import synapse
    out = {}
    for N in (1, 16):
        for const_addr, thr in ((False, synapse.SPARSE_THRESHOLD),
                                (True, synapse.SPARSE_THRESHOLD_CONST_ADDR)):
            label = ("const_addr" if const_addr else "general") + f"_N{N}"
            print(f"# synaptic window density sweep [T={T}, N={N}, R={R}, "
                  f"C={C}], {label} (ms a window)")
            rows, cross = sweep(device, const_addr, N)
            print(f"  crossover (dense at least as fast as sparse) at p = "
                  f"{cross:g}; the port's threshold for this form: {thr:g} "
                  f"(calibrated on a TPU, unchanged)", flush=True)
            out[label] = dict(sweep=rows, crossover_density=cross,
                              threshold=thr, instances=N)
    return out


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
