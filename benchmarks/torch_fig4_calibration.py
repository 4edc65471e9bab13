"""Paper Fig. 4 on the port: the STP efficacy-offset distribution before
and after Monte-Carlo calibration.

    python3 benchmarks/torch_fig4_calibration.py [--device cpu] [--json FILE]

Two cells: 128 virtual drivers (``sigma_stp_offset * N(0, 1)`` from a
numpy seed, as ``benchmarks/fig4_calibration.py``) and the full chip's
16 x 256 drivers of path A's instance (``sample_instance`` with a CPU
generator seeded 11, the instance ``chip_smoke.py`` runs). For each: the
offset spread before (mid-scale trim code) and after the 4-bit binary
search, its histogram over [-0.8, 0.8), the narrowing factor, and the
time of ``calibrate_stp`` (median of 11 calls after one warm-up; CUDA
events on a card, with its name and power limit; the host clock with
``--device cpu``, which is no device measurement). Runs on the card
unless ``--device cpu`` is given; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def _median_ms(fn, device, reps=11):
    import torch
    fn()
    times = []
    for _ in range(reps):
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
    return sorted(times)[len(times) // 2]


def run(device):
    import numpy as np
    import torch
    from repro_torch.configs.bss2 import BSS2
    from repro_torch.verif.calibration import calibrate_stp
    from repro_torch.verif.mismatch import sample_instance
    offsets = {
        "128_drivers": torch.as_tensor(
            BSS2.mismatch.sigma_stp_offset * np.random.default_rng(42)
            .standard_normal(128).astype(np.float32), device=device),
        "full_chip_16x256": sample_instance(
            BSS2, torch.Generator().manual_seed(11), (16,),
            device=device)["stp_offset"]}
    out = {}
    for name, off in offsets.items():
        codes, m = calibrate_stp(BSS2, off)
        before = m["before"].cpu().numpy().ravel()
        after = m["after"].cpu().numpy().ravel()
        hist = {k: np.histogram(v, bins=16, range=(-0.8, 0.8))[0].tolist()
                for k, v in (("before", before), ("after", after))}
        sb, sa = float(m["std_before"]), float(m["std_after"])
        ms = _median_ms(lambda: calibrate_stp(BSS2, off), device)
        out[name] = dict(drivers=off.numel(), std_before=sb, std_after=sa,
                         narrowing=sb / max(sa, 1e-9),
                         max_abs_after=float(m["max_abs_after"]),
                         calibrate_ms=ms, hist=hist,
                         codes_used=sorted(set(codes.cpu().view(-1)
                                               .tolist())))
        print(f"{name}: {off.numel()} drivers, std {sb:.4f} -> {sa:.4f} "
              f"({sb / max(sa, 1e-9):.1f}x narrower), max |after| "
              f"{float(m['max_abs_after']):.4f}; calibrate_stp "
              f"{ms:.3f} ms ({'CUDA events' if device.type == 'cuda' else 'host clock, CPU'})")
        for k in ("before", "after"):
            print(f"  {k:6s} [{' '.join(f'{c:3d}' for c in hist[k])}]")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
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
    res = dict(device=str(device), card=card, cells=run(device))
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
