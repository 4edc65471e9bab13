"""PPU-VM against the fixed-function R-STDP path, on the port.

    python3 benchmarks/torch_ppuvm_bench.py [--device cpu] [--json FILE]

The port's counterpart of ``benchmarks/ppuvm_bench.py``, with two rungs:

- Rule only: ``VectorUnit.apply_rstdp_program`` (the PPU-VM kernel
  ``ppuvm_exec`` running ``programs.rstdp_program``) against
  ``VectorUnit.apply_rstdp`` (the fixed-function ``ppu_update`` kernel)
  on the same observables and one injected xi, at the full 256 x 512 chip
  and at the 16-instance fleet [16, 256, 512]; weights within one code
  (the reference's contract). Timed with CUDA events (median and best of
  20 after a warm-up).
- In the trial graph: the §5 experiment (32 x 16, 50 trials of T = 256,
  seed 0) with ``rule_impl="vm"`` against ``"python"``, both through
  ``make_scanned_training`` (the trial captured once and replayed); the
  run timed again after a first run that captures, in microseconds a
  trial.

There is no executor ladder: the reference's specializer and its
``executor=`` knobs are not ported (eager PyTorch has nothing to trace;
the VM kernel decodes the words once). Each number is printed beside the
card's name and power limit; with ``--device cpu`` the host clock, which
is no device measurement. Exits non-zero without a card unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
REPEATS = 20
N_TRIALS = 50


def _timed(fn, device, reps=REPEATS):
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
    times.sort()
    return times[len(times) // 2], times[0]


def rule_only(device):
    import torch
    from repro_torch.configs.bss2 import BSS2
    from repro_torch.core.anncore import AnnCore
    from repro_torch.core.ppu import VectorUnit
    from repro_torch.ppuvm import programs
    from repro_torch.verif.mismatch import sample_instance
    rows = {}
    words = torch.as_tensor(programs.rstdp_program(eta=0.5), device=device)
    for prefix in ((), (16,)):
        gen = torch.Generator().manual_seed(1)
        inst = sample_instance(BSS2, torch.Generator().manual_seed(0),
                               prefix, device=device)
        ppu = VectorUnit(BSS2, inst)
        st = AnnCore(BSS2, inst).init_state(prefix)
        shape = (*prefix, BSS2.n_rows, BSS2.n_cols)

        def draw(*s, hi=1.0):
            return (hi * torch.rand(s, generator=gen)).to(device)
        st = st._replace(
            syn=st.syn._replace(weights=torch.randint(
                0, 64, shape, generator=gen, dtype=torch.int8).to(device)),
            corr=st.corr._replace(a_causal=draw(*shape, hi=8.0),
                                  a_acausal=draw(*shape, hi=8.0)))
        reward = (draw(*prefix, BSS2.n_cols) < 0.5).to(torch.float32)
        rs = dict(mean_reward=torch.zeros((*prefix, BSS2.n_cols),
                                          device=device))
        xi = 0.3 * torch.randn(shape, generator=gen).to(device)

        def fixed():
            return ppu.apply_rstdp(st, dict(rs), reward=reward, eta=0.5,
                                   xi=xi)

        def vm():
            return ppu.apply_rstdp_program(st, dict(rs), reward=reward,
                                           program=words, xi=xi)
        dq = (fixed()[0].syn.weights.to(torch.int32)
              - vm()[0].syn.weights.to(torch.int32)).abs()
        if int(dq.max()) > 1:
            raise AssertionError(f"vm differs from fixed by {int(dq.max())}"
                                 " codes")
        t_f, b_f = _timed(fixed, device)
        t_v, b_v = _timed(vm, device)
        key = "x".join(map(str, shape))
        rows[key] = dict(fixed_ms=t_f, fixed_best_ms=b_f, vm_ms=t_v,
                         vm_best_ms=b_v, vm_over_fixed=t_v / t_f,
                         codes_off_by_one=int((dq > 0).sum()),
                         n_words=int(words.numel()))
        print(f"rule only [{key}], {words.numel()} words: fixed "
              f"{t_f:.4f} ms (best {b_f:.4f}), vm {t_v:.4f} ms (best "
              f"{b_v:.4f}), vm / fixed {t_v / t_f:.2f}x; "
              f"{rows[key]['codes_off_by_one']} codes off by one",
              flush=True)
    return rows


def in_graph(device):
    import torch
    from repro_torch.core.hybrid import (RSTDPConfig, make_experiment,
                                         make_scanned_training, stimuli)
    ecfg = RSTDPConfig()
    stims = stimuli(N_TRIALS)
    res = {}
    for impl in ("python", "vm"):
        init, _, meta = make_experiment(
            ecfg=ecfg, generator=torch.Generator().manual_seed(0),
            rule_impl=impl, device=device)
        draws = meta["draw"](torch.Generator().manual_seed(1), stims)
        scanned = make_scanned_training(meta)
        out = {}

        def once():
            out["hist"] = scanned(init(), stims, draws)[1]
        med, best = _timed(once, device, reps=5)
        res[impl] = dict(us_per_trial=1e3 * med / N_TRIALS,
                         best_us_per_trial=1e3 * best / N_TRIALS,
                         final_median_reward=float(
                             out["hist"]["mean_reward"][-1].median()))
        print(f"in the trial graph, rule_impl={impl!r}: "
              f"{res[impl]['us_per_trial']:.1f} us a trial (best "
              f"{res[impl]['best_us_per_trial']:.1f}), {N_TRIALS} trials of "
              f"{2 * ecfg.n_inputs} x {ecfg.n_neurons}", flush=True)
    res["vm_over_python"] = (res["vm"]["us_per_trial"]
                             / res["python"]["us_per_trial"])
    print(f"vm / python in the trial graph: {res['vm_over_python']:.2f}x")
    return res


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
    res = dict(device=str(device), card=card, rule_only=rule_only(device),
               in_graph=in_graph(device))
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
