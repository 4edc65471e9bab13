"""Network-mapper benchmarks on the port: compile time, relay overhead,
mapped against monolithic time a window.

    python3 benchmarks/torch_mapper_bench.py [--device cpu] [--json FILE]

The port's counterpart of ``benchmarks/mapper_bench.py``, with its three
rungs:

- Mapping time by network size: ``map_network`` onto 4 native 256 x 512
  chips (all2all) of locality-structured specs (each input drives 4
  neighbouring neurons) of 100 x 100, 200 x 400 and 300 x 700, and the
  480 x 2048 spec of ``chip_smoke.py``'s path F; best of 5 on the host
  clock (the mapper is host numpy, the same code on every device).
- Relay overhead against recurrent fan-in on a K = 4 ring: recurrent
  edges allowed at chip distance 1 (direct) and 2 (one relay hop), fan-in
  1, 2, 4 and 6: relayed edges and transit rows.
- Mapped against monolithic time a window: the same random 64 x 128
  network (fan-out 8, recurrent fan-out 2, Dale) on 4 chips of 32 columns
  and on one chip of 128, W = 2 windows of T = 64; and path F's 480 x
  2048 spec on four 256 x 512 chips against one 968 x 2048 virtual chip,
  W = 4 windows of T = 128 (Poisson inputs, p = 0.05). ``rt.run`` timed
  with CUDA events (median and best of 5 after a warm-up), in
  microseconds a window, as it runs by default (one captured window
  replayed once a window; on the CPU the window loop's body) and with
  ``eager=True`` (``run_windows``); the spikes of all four equal bit for
  bit.

Each number is printed beside the card's name and power limit. With
``--device cpu`` the windows run on the host clock, which is no device
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

import numpy as np

REPO = Path(__file__).resolve().parents[1]
REPEATS = 5
SIZES = ((100, 100), (200, 400), (300, 700))
K = 4
FAN_INS = (1, 2, 4, 6)


def path_f_spec():
    """``chip_smoke.py``'s path-F network (``tests/_torch_mapper.py``):
    480 inputs x 2048 neurons, 4,864 edges."""
    sys.path.insert(0, str(REPO / "tests"))
    import _torch_mapper
    return _torch_mapper.path_f_spec()


def _timed(fn, device):
    """Median and best of ``REPEATS`` timings of ``fn`` in ms after one
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


def mapping_time():
    from repro_torch import mapper
    rows = []
    specs = []
    for n_in, n_neurons in SIZES:
        w_in = np.zeros((n_in, n_neurons), np.int32)
        stride = max(1, n_neurons // n_in)
        for i in range(n_in):
            for d in range(4):
                w_in[i, (i * stride + d) % n_neurons] = 30 - 5 * d
        specs.append(mapper.NetworkSpec(n_in=n_in, n_neurons=n_neurons,
                                        w_in=w_in))
    specs.append(path_f_spec())
    for spec in specs:
        best = float("inf")
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            m = mapper.map_network(spec, n_chips=K)
            best = min(best, time.perf_counter() - t0)
        rows.append(dict(n_in=spec.n_in, n_neurons=spec.n_neurons,
                         edges=spec.n_edges, ms=best * 1e3,
                         rows_used=int(m.rows_used().sum())))
        print(f"map {spec.n_in}x{spec.n_neurons} ({spec.n_edges} edges) -> "
              f"{K} chips: {best * 1e3:7.1f} ms (host), "
              f"{rows[-1]['rows_used']} rows", flush=True)
    return rows


def relay_overhead(rng):
    from repro_torch import mapper
    n_in, n_neurons = 32, 64
    block = n_neurons // K
    chip_of = np.arange(n_neurons) // block
    dist = (chip_of[None, :] - chip_of[:, None]) % K
    rec_mask = (dist == 1) | (dist == 2)
    rows = []
    for f in FAN_INS:
        spec = mapper.random_spec(rng, n_in, n_neurons, fan_out=2,
                                  rec_fan_out=f, dale=True,
                                  rec_mask=rec_mask)
        m = mapper.map_network(spec, n_chips=K, chip_rows=256,
                               chip_cols=block, topology="ring")
        n_rec = int((spec.w_rec != 0).sum())
        rows.append(dict(rec_fan_out=f, rec_edges=n_rec,
                         relayed_edges=m.n_relayed_edges,
                         transit_rows=m.n_transit_rows))
        print(f"ring fan-in {f}: {n_rec:3d} rec edges, "
              f"{m.n_relayed_edges:3d} relayed, {m.n_transit_rows:3d} "
              f"transit rows", flush=True)
    return rows


def step_time(rng, device):
    import torch
    from repro_torch import mapper
    from repro_torch.configs.bss2 import BSS2
    cases = {}
    small = mapper.random_spec(rng, 64, 128, fan_out=8, rec_fan_out=2,
                               dale=True)
    big = path_f_spec()
    for name, spec, cfg, W, T, layouts in (
            ("random 64x128", small, None, 2, 64,
             (("monolithic", 1, 128), ("mapped", K, 32))),
            ("path F 480x2048", big, BSS2, 4, 128,
             (("monolithic", 1, 2048), ("mapped", K, 512)))):
        ev = torch.from_numpy((rng.random((W, T, spec.n_in)) < 0.05).astype(
            np.float32)).to(device)
        net_inst = None
        row, spikes = {}, {}
        for label, n_chips, cols in layouts:
            rows = (256 if cols == 512 else
                    max(mapper.min_chip_rows(spec, n_chips, cols) + 8, 8))
            m = mapper.map_network(spec, n_chips=n_chips, chip_rows=rows,
                                   chip_cols=cols)
            rt = mapper.build_runtime(m, cfg=cfg, net_inst=net_inst,
                                      device=device)
            net_inst = rt.net_inst
            res = {}
            row[label] = dict(chips=n_chips, chip_rows=rows, chip_cols=cols)
            for mode, eager in (("", False), ("eager_", True)):
                def run():
                    res[mode] = rt.run(ev, eager=eager)[1]["spikes"]
                med, best = _timed(run, device)
                row[label].update({f"{mode}us_per_window": 1e3 * med / W,
                                   f"{mode}best_us_per_window":
                                   1e3 * best / W})
            if not torch.equal(res[""], res["eager_"]):
                raise AssertionError(f"{name}, {label}: run != eager run")
            spikes[label] = res[""]
            row[label]["spikes"] = float(spikes[label].sum())
            r = row[label]
            print(f"{name}, {label} ({n_chips} x {rows} x {cols}): "
                  f"{r['us_per_window']:9.1f} us/window (best "
                  f"{r['best_us_per_window']:.1f}), eager "
                  f"{r['eager_us_per_window']:.1f} (best "
                  f"{r['eager_best_us_per_window']:.1f}), "
                  f"{r['spikes']:.0f} spikes", flush=True)
        if not torch.equal(spikes["mapped"], spikes["monolithic"]):
            raise AssertionError(f"{name}: mapped != monolithic spikes")
        row["mapped_over_monolithic"] = (row["mapped"]["us_per_window"]
                                         / row["monolithic"]["us_per_window"])
        print(f"{name}: mapped / monolithic = "
              f"{row['mapped_over_monolithic']:.2f}x, spikes bit-equal",
              flush=True)
        cases[name] = row
    return cases


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
    rng = np.random.default_rng(0)
    res = dict(device=str(device), card=card, mapping_time=mapping_time(),
               relay_overhead=relay_overhead(rng),
               step_time=step_time(rng, device))
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
