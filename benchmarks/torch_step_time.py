"""The §5 experiment's host / eager / graph ladder on a card.

    python3 benchmarks/torch_step_time.py [--json FILE]

The port's counterpart of ``benchmarks/step_time.py``: the three modes of
``repro_torch.core.hybrid.run_training`` on one CUDA card,

- host: ``host_loop_trial`` (``fused=False``), every state tensor to the
  host and back before a trial and the metrics to the host after it;
- eager: a Python loop of eager trials (``scan=False``);
- graph: one trial captured as a CUDA graph and replayed once a trial
  (the default), its warm-up and capture timed apart,

at the §5 closed loop's 32 x 16 geometry (450 trials, T = 256, one
instance) and at full width (16 instances of the 256 x 512 chip, 128
inputs x 512 neurons, T = 128, 6 trials: A, B, none, A, B, none). Each
cell builds its experiment and draws once; the modes run in turns (graph,
eager, host, host, eager, graph), each timed with CUDA events from before
its first trial to after its last, and the best of the two runs is kept.
Each timed run follows an untimed run of the same mode: a capture empties
the allocator's cache (``torch.cuda.graph`` does), and a mode that found
it empty would pay for ``cudaMalloc`` calls the mode does not make when
it runs alone.
The three histories must be equal bit for bit. The card's name and power
limit (``nvidia-smi``) are printed beside the times; compare numbers only
within one run. Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def _cells():
    import torch
    from repro_torch.configs.bss2 import BSS2
    from repro_torch.core.hybrid import RSTDPConfig
    full = dict(cfg=BSS2, ecfg=RSTDPConfig(n_inputs=128, n_neurons=512,
                                           pattern_size=24, trial_steps=128),
                prefix=(16,), backend="blocked")
    return {"32x16": (dict(), 450, torch.Generator().manual_seed(0)),
            "full_width": (full, 6, torch.Generator().manual_seed(11))}


def _cuda_ms(fn):
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b), out


def run_cell(name, kw, n, gen):
    import numpy as np
    import torch
    from repro_torch.core import hybrid as th
    init, trial, meta = th.make_experiment(generator=gen, device="cuda",
                                           **kw)
    stims = th.stimuli(n)
    draws = meta["draw"](torch.Generator().manual_seed(12), stims)

    def host():
        state, hist = init(), []
        for i, s in enumerate(stims):
            state, m = th.host_loop_trial(trial, state, s, draws.events[i],
                                          draws.xi[i])
            hist.append(m)
        return {k: torch.stack([h[k] for h in hist]) for k in hist[0]}

    def eager():
        return meta["train"](init(), stims, draws)[1]

    capture = []

    def graph():
        cap_ms, g = _cuda_ms(lambda: th.TrialGraph(th.TrialLoop(
            trial, init(), stims, draws)))
        capture.append(cap_ms)
        replay_ms, _ = _cuda_ms(lambda: [g.replay() for _ in range(n)])
        return replay_ms, g.loop.history()

    times = {"graph": [], "eager": [], "host": [], "graph_replays": []}
    hists = {}
    for mode in ("graph", "eager", "host", "host", "eager", "graph"):
        fn = {"graph": graph, "eager": eager, "host": host}[mode]
        fn()                                    # untimed: the same mode
        ms, hist = _cuda_ms(fn)
        if mode == "graph":
            replay_ms, hist = hist
            times["graph_replays"].append(replay_ms)
        times[mode].append(ms)
        hists[mode] = {k: v.cpu().numpy() for k, v in hist.items()}
    for mode in ("eager", "host"):
        for k in hists["graph"]:
            if k != "stim" and not np.array_equal(hists[mode][k],
                                                  hists["graph"][k]):
                raise AssertionError(f"{name}: {k} differs between graph "
                                     f"and {mode}")
    best = {k: min(v) for k, v in times.items()}
    row = dict(cell=name, n_trials=n,
               ms_per_trial={k: best[k] / n for k in ("host", "eager",
                                                       "graph")},
               graph_replay_ms_per_trial=best["graph_replays"] / n,
               graph_capture_ms=min(capture), runs_ms=times,
               bit_equal=True)
    print(f"{name}: {n} trials; ms per trial (best of 2, CUDA events): host "
          f"{row['ms_per_trial']['host']:.3f}, eager "
          f"{row['ms_per_trial']['eager']:.3f}, graph "
          f"{row['ms_per_trial']['graph']:.3f} (replays alone "
          f"{row['graph_replay_ms_per_trial']:.4f}; warm-up and capture "
          f"{row['graph_capture_ms']:.1f} ms); eager / graph "
          f"{best['eager'] / best['graph']:.2f}x, host / graph "
          f"{best['host'] / best['graph']:.2f}x; histories bit-equal",
          flush=True)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", help="write the results here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_step_time.py: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO / "src"))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    rows = [run_cell(name, *cell) for name, cell in _cells().items()]
    if args.json:
        Path(args.json).write_text(json.dumps(dict(card=smi, cells=rows),
                                              indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
