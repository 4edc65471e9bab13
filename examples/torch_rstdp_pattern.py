"""End-to-end reproduction of the paper's §5 experiment (Fig. 10/11) on
the port (the counterpart of ``examples/rstdp_pattern.py``).

16 Poisson input channels; patterns A and B on 5 channels each (40%
overlap); even neurons are rewarded for firing on A, odd neurons on B; the
R-STDP rule (Eqs. 2-3) runs on the PPU against the analog correlation
sensors. On the card the trial is captured once as a CUDA graph and
replayed every trial.

Run:  PYTHONPATH=src python examples/torch_rstdp_pattern.py [n_trials]
          [--device cpu]

Runs on the CUDA card unless ``--device cpu`` is given (and raises
without one).
"""
import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.hybrid import RSTDPConfig, run_training


def _host(x):
    """A metadata array (a device tensor or numpy) as numpy."""
    import torch
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def ascii_plot(series, width=64, height=10, lo=0.0, hi=1.0):
    xs = np.linspace(0, len(series) - 1, width).astype(int)
    ys = np.asarray(series)[xs]
    rows = []
    for h in range(height, -1, -1):
        thr = lo + (hi - lo) * h / height
        rows.append("".join("#" if y >= thr else " " for y in ys))
    return "\n".join(f"{lo + (hi - lo) * (height - i) / height:4.2f} |{r}"
                     for i, r in enumerate(rows))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("n_trials", nargs="?", type=int, default=450)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    device = resolve_device(args.device)
    ecfg = RSTDPConfig(overlap=0.4)
    print(f"training {args.n_trials} trials, overlap={ecfg.overlap:.0%} on "
          f"{device} ...")
    out, _, meta = run_training(n_trials=args.n_trials, ecfg=ecfg, seed=0,
                                device=device)
    even = _host(meta["even"]) > 0
    mr = out["mean_reward"]
    print("\nmedian mean-expected-reward over training (paper Fig. 11 B):")
    print(ascii_plot(np.median(mr, axis=1)))
    print(f"\nfinal: A-pop {np.median(mr[-1, even]):.3f}  "
          f"B-pop {np.median(mr[-1, ~even]):.3f}")

    w = out["w_signed_final"]
    ma = _host(meta["mask_a"]) > 0
    mb = _host(meta["mask_b"]) > 0
    print("\nlearned signed weights (paper Fig. 11 A analogue):")
    print(f"  A-channels -> even neurons: {w[ma][:, even].mean():+6.1f}")
    print(f"  A-channels -> odd  neurons: {w[ma][:, ~even].mean():+6.1f}")
    print(f"  B-channels -> even neurons: {w[mb][:, even].mean():+6.1f}")
    print(f"  B-channels -> odd  neurons: {w[mb][:, ~even].mean():+6.1f}")
    print(f"  background -> any         : {w[~(ma | mb)].mean():+6.1f}")


if __name__ == "__main__":
    main()
