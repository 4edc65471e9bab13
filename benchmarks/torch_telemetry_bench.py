"""Telemetry overhead on the port: the §5 experiment with the counters off
and on, as eager trials and as graph replays.

    python3 benchmarks/torch_telemetry_bench.py [--device cpu] [--json FILE]

The port's counterpart of ``benchmarks/telemetry_bench.py``. Two cells:
the §5 closed loop's 32 x 16 geometry (60 trials, T = 256) and path A's
full width (16 instances of the 256 x 512 chip, T = 128, 6 trials: A, B,
none, A, B, none). In each, one experiment with ``telemetry=False`` and
one with ``telemetry=True`` (the same instance and draws) run their
trials eagerly (``meta["train"]``) and as replays of a captured trial
graph (``make_scanned_training``), in turns (off, on, on, off, ...), each
run timed from before its first trial to after its last (CUDA events on
a card, beside its name and power limit). The overhead is the median of
the paired on/off ratios. The off and on histories must be equal bit for
bit. Also printed: the on run's counters and a phase split of one
window (``obs.timing.profile_phases``). With ``--device cpu`` only the
eager mode runs (no graphs on the CPU), timed on the host clock, which is
no device measurement. Exits non-zero without a card unless ``--device
cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PAIRS = 4


def _timed(fn, device):
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


def _cells():
    from repro_torch.configs.bss2 import BSS2
    from repro_torch.core.hybrid import RSTDPConfig, stimuli
    full = dict(cfg=BSS2, ecfg=RSTDPConfig(n_inputs=128, n_neurons=512,
                                           pattern_size=24, trial_steps=128),
                prefix=(16,), backend="blocked")
    return {"32x16": (dict(), stimuli(60), 0),
            "full_width": (full, stimuli(6), 11)}


def run(device):
    import numpy as np
    import torch
    from repro_torch.core import hybrid as th
    from repro_torch.obs import trace as obs_trace
    from repro_torch.obs.timing import profile_phases
    out = {}
    for cell, (kw, stims, seed) in _cells().items():
        exps = {on: th.make_experiment(
            generator=torch.Generator().manual_seed(seed), device=device,
            telemetry=on, **kw) for on in (False, True)}
        draws = exps[False][2]["draw"](
            torch.Generator().manual_seed(seed + 1), stims)
        modes = {"eager": lambda m: m["train"]}
        if device.type == "cuda":
            modes["graph"] = lambda m: th.make_scanned_training(m)
        res = {}
        for mode, runner in modes.items():
            fns = {on: (lambda on=on: runner(exps[on][2])(
                exps[on][0](), stims, draws)) for on in exps}
            last = {on: fns[on]() for on in fns}          # warm-up, capture
            times = {False: [], True: []}
            for i in range(PAIRS):
                for on in ((False, True) if i % 2 == 0 else (True, False)):
                    ms, last[on] = _timed(fns[on], device)
                    times[on].append(ms / len(stims))
            (s_off, h_off), (s_on, h_on) = last[False], last[True]
            for k in h_off:
                if not torch.equal(h_off[k], h_on[k]):
                    raise AssertionError(f"{cell} {mode}: {k} differs with "
                                         "telemetry on")
            ratios = sorted(b / a for a, b in zip(times[False], times[True]))
            res[mode] = dict(
                off_ms_per_trial=float(np.median(times[False])),
                on_ms_per_trial=float(np.median(times[True])),
                overhead_x_paired=ratios[len(ratios) // 2],
                counters=obs_trace.summary(s_on.tele))
            r = res[mode]
            print(f"{cell} {mode}: off {r['off_ms_per_trial']:.4f} ms a "
                  f"trial, on {r['on_ms_per_trial']:.4f}, "
                  f"{r['overhead_x_paired']:.3f}x (paired median of "
                  f"{PAIRS}); histories bit-equal")
        tele = res["eager"]["counters"]
        print(f"{cell} counters: steps={tele['steps']} trials="
              f"{tele['trials']} in={tele['in_events']} out="
              f"{tele['out_spikes']} dense={tele['dense_windows']} "
              f"sparse={tele['sparse_windows']} gated="
              f"{tele['gated_windows']} fallbacks="
              f"{tele['overflow_fallbacks']} dw_max={tele['dw_abs_max']:.3f}")
        core = exps[False][2]["core"]
        ev = draws.events[0]
        addr = torch.zeros(ev.shape, dtype=torch.int8, device=device)
        phases = profile_phases(core, exps[False][0]().core, ev, addr,
                                iters=5)
        print(f"{cell} phase split of one window (best us): " + "  ".join(
            f"{k}={v['best_us']:.1f}" for k, v in phases.items()))
        out[cell] = dict(res, phase_us={k: v["best_us"]
                                        for k, v in phases.items()})
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
    res = dict(device=str(device), card=card, cells=run(device))
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
