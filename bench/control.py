"""The readings the limits of ``correct`` are set from: for each seed, the
numbers the program's calls read against the reference (the lower
readings) and those the control reads, the reference computed in a lower
precision and put in the program's place (the upper readings).

    python3 bench/control.py --workload <cell> --seeds 1,2,3

Each seed builds the cell as a run does, runs its calls up to the last
one the seed samples (no window, no timing), then compares the kept
calls with the reference: once the program's outputs, then once each
control's (``--precisions``, default ``tf32,bf16``). One JSON line a
seed. It runs where the cell runs (on the card);
``bench/test_bench_correct.py`` runs it on the CPU at a small size. The
benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

BENCH = Path(__file__).resolve().parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import runner  # noqa: E402


def readings(root: Path, workload: str, seeds, precisions, device=None,
             config_overrides=None, mix_overrides=None):
    """Yield ``{"seed", "program", <precision>...}`` a seed, each entry
    the readings {number: value}."""
    spec = runner.load_json(root / "BENCHMARK.json")
    cell, conf = runner.lookup(spec, workload)
    config = runner.load_json(root / conf["file"])
    config.update(config_overrides or {})
    mix = runner.load_json(root / "bench" / "mixes" /
                           f"{cell['traffic']}.json")
    mix.update(mix_overrides or {})
    torch = runner.prepare_torch(root)
    module = runner.load_module(
        Path(root / conf["file"]).with_suffix(".py"),
        "bench_config_" + conf["name"].replace("-", "_"))
    device = torch.device(device or "cuda")
    for seed in seeds:
        ctx = SimpleNamespace(torch=torch, device=device, seed=seed,
                              config=config, mix=mix)
        t = time.perf_counter()
        system = module.setup(ctx)
        system.warmup()
        for k in range(max(system.sample) + 1):
            system.call(k)
        system.release()
        kept = dict(system.kept)
        out = {"seed": seed}
        for prec in [None, *precisions]:
            system.kept = dict(kept)
            got, _, _ = system.check(control=prec)
            out[prec or "program"] = {n: v for n, (v, _) in got.items()}
        out["seconds"] = time.perf_counter() - t
        del system, kept
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        yield out


def main(argv):
    ap = argparse.ArgumentParser(description="limits' readings of a cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--precisions", default="tf32,bf16")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    precs = [p for p in args.precisions.split(",") if p]
    for line in readings(BENCH.parent, args.workload, seeds, precs,
                         args.device):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
