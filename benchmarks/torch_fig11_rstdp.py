"""Paper Fig. 11 on the port: R-STDP pattern discrimination, the median
expected reward <R> of both populations over the 450 trials.

    python3 benchmarks/torch_fig11_rstdp.py [--device cpu] [--trials N]
                                            [--json FILE]

The counterpart of ``benchmarks/fig11_rstdp.py``: ``run_training`` of the
§5 experiment (32 x 16, 40% pattern overlap, seed 0; on the card the
captured trial graph, replayed), the median <R> of the even (A) and odd
(B) neurons at 10, 25, 50, 75 and 100% of the trials, and the mean of the
per-trial medians over the last 100 trials (the paper: "converges to
approximately one for all neurons"; the repo's tier-3 bar is > 0.85,
``tests/test_rstdp.py``). The run's time on the host clock is printed
beside the card's name and power limit.
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


def _host(x):
    """A metadata array (a device tensor or numpy) as numpy."""
    import torch
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def run(device, n_trials=450):
    import torch
    from repro_torch.core.hybrid import run_training
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, _, meta = run_training(n_trials=n_trials, seed=0, device=device)
    secs = time.perf_counter() - t0
    even = _host(meta["even"]) > 0
    mr = out["mean_reward"]

    def med(t, sel):
        return float(np.median(mr[t, sel]))
    print(f"# Fig. 11 on the port: median <R> per population (40% overlap), "
          f"{device}")
    curve = []
    for frac in (0.1, 0.25, 0.5, 0.75, 1.0):
        t = int(n_trials * frac) - 1
        curve.append(dict(trial=t, even=med(t, even), odd=med(t, ~even)))
        print(f"trial {t:4d}: A-pop(even)={curve[-1]['even']:.3f} "
              f"B-pop(odd)={curve[-1]['odd']:.3f}")
    n = min(100, n_trials)
    trail_e = float(np.mean(np.median(mr[-n:, :][:, even], axis=1)))
    trail_o = float(np.mean(np.median(mr[-n:, :][:, ~even], axis=1)))
    print(f"trailing-{n} mean of medians: even={trail_e:.3f} "
          f"odd={trail_o:.3f}; {n_trials} trials in {secs:.2f} s (host "
          f"clock, capture included)")
    return dict(curve=curve, trailing_even=trail_e, trailing_odd=trail_o,
                seconds=secs, n_trials=n_trials)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--trials", type=int, default=450)
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
    res = dict(device=str(device), card=card, **run(device, args.trials))
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
