"""One telemetered training run on the port -> a structured run report.

A short §5 training with the counters and the spans on (the scanned
call's load, replays and clones, the last trial's emulation, rule and
carry, the capture), a phase split of one emulation window, merged with
config and provenance (commit, PyTorch version, the card's name) into
JSON + markdown.

Run:  PYTHONPATH=src python examples/torch_telemetry_report.py \
          [--device cpu] [--trials N] [--rule vm|python] [--json PATH]

Runs on the CUDA card unless ``--device cpu`` is given (and raises
without one). The report goes to ``build/reports/`` unless ``--json``
names a path.
"""
import argparse
from pathlib import Path

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.hybrid import run_training
from repro_torch.obs import report as obs_report
from repro_torch.obs.timing import profile_phases


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--trials", type=int, default=30)
    ap.add_argument("--rule", default="vm", choices=("vm", "python"),
                    help="plasticity implementation (vm exercises the "
                         "PPU-VM counters)")
    ap.add_argument("--json", default=None, metavar="PATH")
    ap.add_argument("--md", default=None, metavar="PATH")
    args = ap.parse_args()
    device = resolve_device(args.device)

    out, state, meta = run_training(args.trials, seed=0, rule_impl=args.rule,
                                    telemetry=True, device=device)
    tele = out["telemetry"]
    spans = meta["timer"].summary()

    core, ecfg = meta["core"], meta["ecfg"]
    rng = np.random.default_rng(0)
    ev = torch.as_tensor((rng.random((ecfg.trial_steps, core.cfg.n_rows))
                          < 0.02).astype(np.float32), device=device)
    ad = torch.zeros(ev.shape, dtype=torch.int8, device=device)
    phases = profile_phases(core, core.init_state(), ev, ad, iters=3)

    rep = obs_report.build_report(
        "telemetry_demo", telemetry=tele, timings={**spans, **phases},
        config=dict(n_trials=args.trials, rule_impl=args.rule,
                    device=str(device)),
        extra=dict(median_reward_final=float(
            np.median(out["mean_reward"][-1]))))
    json_path = args.json or str(Path(__file__).resolve().parents[1]
                                 / "build" / "reports"
                                 / "REPORT_telemetry_demo.json")
    paths = obs_report.write_report(rep, json_path, args.md)
    print(obs_report.to_markdown(rep))
    print(f"wrote {paths['json']} and {paths['md']}")

    # a telemetered run reports real activity
    assert tele["out_spikes"] > 0 and tele["steps"] > 0
    assert tele["trials"] == args.trials
    assert spans["scan.calls"]["count"] == 1
    if args.rule == "vm":
        assert tele["vm_runs"] == args.trials
    return paths


if __name__ == "__main__":
    main()
