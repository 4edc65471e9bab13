#!/usr/bin/env python3
"""Path I (``chip_smoke.py`` phase 16: qwen1.5-0.5b served and smollm-360m
trained on a 1 x 1 device mesh against no mesh, on one card) of two
checkouts of the repo, in turns.

    python3 benchmarks/torch_path_i_turns.py TREE_A TREE_B [--rounds N]

Each run is a fresh process that imports ``TREE/chip_smoke.py`` and
``TREE/src`` and calls its ``phase_path_i()`` (TF32 off, as
``chip_smoke.py`` sets it); the order is A B B A, N times. Prints each
run's ``mesh_path_i`` record tagged with its tree, and last a
``path_i_turns`` JSON line: each tree's decode ms a token and prefill ms
with and without the mesh, and its training step ms, as lists in run
order. Needs a CUDA card (NCCL on a world of one).
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

CHILD = """
import sys
tree = sys.argv[1]
sys.path.insert(0, tree + "/src")
sys.path.insert(0, tree)
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke
chip_smoke.phase_path_i()
"""

KEYS = ("decode_ms_per_token_mesh", "decode_ms_per_token_plain",
        "prefill_ms_mesh", "prefill_ms_plain", "step_ms_mesh",
        "step_ms_plain")


def run(tree: Path) -> dict:
    out = subprocess.run([sys.executable, "-c", CHILD, str(tree)],
                         cwd=tree, capture_output=True, text=True,
                         timeout=900)
    rec = [ln for ln in out.stdout.splitlines()
           if ln.startswith("mesh_path_i ")]
    if out.returncode or not rec:
        raise SystemExit(f"{tree}: rc {out.returncode}\n"
                         f"{out.stdout[-3000:]}{out.stderr[-3000:]}")
    return json.loads(rec[-1][len("mesh_path_i "):])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs=2, type=Path)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    a, b = (t.resolve() for t in args.trees)
    turns = {str(a): {k: [] for k in KEYS}, str(b): {k: [] for k in KEYS}}
    for _ in range(args.rounds):
        for tree in (a, b, b, a):
            rec = run(tree)
            print(f"tree {tree}: mesh_path_i {json.dumps(rec)}", flush=True)
            for k in KEYS:
                if k in rec:
                    turns[str(tree)][k].append(rec[k])
    print("path_i_turns " + json.dumps(turns), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
