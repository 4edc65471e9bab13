"""Pre-tapeout calibration workflow on the port (paper §3.2.2): sample a
virtual chip instance, calibrate its STP offsets by binary search, and
run the §5 hybrid-plasticity experiment on the calibrated chip.

Run:  PYTHONPATH=src python examples/torch_calibrate_and_run.py \
          [--device cpu] [--trials N]

Runs on the CUDA card unless ``--device cpu`` is given (and raises
without one).
"""
import argparse
import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.configs.bss2 import BSS2
from repro_torch.core import stp
from repro_torch.core.hybrid import RSTDPConfig, run_training
from repro_torch.verif.calibration import calibrate_stp
from repro_torch.verif.mismatch import sample_instance


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--trials", type=int, default=60)
    args = ap.parse_args()
    device = resolve_device(args.device)

    # 1. a virtual instance (fixed seed = the same "silicon" every run)
    cfg = dataclasses.replace(BSS2.reduced(), n_rows=32, n_cols=16)
    inst = sample_instance(cfg, torch.Generator().manual_seed(7),
                           device=device)

    # 2. pre-tapeout calibration of the STP efficacy offsets
    codes, metrics = calibrate_stp(cfg, inst["stp_offset"])
    print(f"STP offsets: std {float(metrics['std_before']):.3f} -> "
          f"{float(metrics['std_after']):.3f} after the 4-bit binary search")
    inst_cal = dict(inst, stp_calib=codes)
    ones = torch.ones(cfg.n_rows, device=device)

    def first_pulse(calib):
        return stp.efficacy(stp.init_state((cfg.n_rows,), device), ones,
                            u=cfg.stp_u, offset=inst["stp_offset"],
                            calib_code=calib)
    spread = [float(first_pulse(c).std()) for c in (inst["stp_calib"],
                                                    codes)]
    print(f"first-pulse efficacy spread across drivers: {spread[0]:.4f} "
          f"uncalibrated vs {spread[1]:.4f} calibrated")
    assert spread[1] < spread[0]

    # 3. the §5 experiment on the calibrated chip and on the raw one
    for name, ins in (("uncalibrated", inst), ("calibrated", inst_cal)):
        out, _, _ = run_training(args.trials, ecfg=RSTDPConfig(), seed=0,
                                 cfg=cfg, device=device, inst=ins)
        mr = out["mean_reward"]
        print(f"{name}: mean reward over the last 15 trials "
              f"{float(mr[-15:].mean()):.3f} (first 15: "
              f"{float(mr[:15].mean()):.3f})")


if __name__ == "__main__":
    main()
