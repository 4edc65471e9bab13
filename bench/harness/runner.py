"""One run of one cell: set-up, the measured window, the traced slice,
the per-layer readers, the comparison with the reference, the result.

Everything a cell is made of is found by name: the cell's entry in
``BENCHMARK.json``, its configuration's module beside the configuration's
file (``configs/<config>.py``), its traffic mix (``mixes/<traffic>.json``)
and a reader for each per-layer metric (``metrics/<metric>.py``). The
configuration's module builds the system under test from the port's
public entry points and says how its calls are kept and judged; this
file times the calls and takes the end-to-end metrics itself:

- ``setup_s``: host clock, from the start of the process to the first
  call of the window (imports, the card's start, inputs made on the
  device, the system built, every shape warmed up and captured);
- the rate (``<unit>_per_s``): the work of every call the window
  completed over the window's time, host clock;
- the call time's 95th percentile: every call of the window, from a CUDA
  event recorded on the stream before the call to one after its outputs,
  on the device's clock (the stream is idle at each call's start).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from harness import peaks as peaks_mod
from harness import trace as trace_mod

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# where in the window the traced slice starts, as a share of its length
TRACE_AT = 0.3


class RunError(Exception):
    """A run that cannot print a result: the message goes to standard
    error and the process exits with 2."""


def eprint(*args):
    print(*args, file=sys.stderr, flush=True)


def load_module(path: Path, name: str):
    if not path.is_file():
        raise RunError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path) -> dict:
    if not path.is_file():
        raise RunError(f"no file {path}")
    return json.loads(path.read_text())


def lookup(spec: dict, workload: str):
    """The cell ``workload`` and its configuration's entry."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise RunError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"there are {sorted(cells)}")
    cell = cells[workload]
    confs = {c["name"]: c for c in spec["configs"]}
    return cell, confs[cell["config"]]


def metrics_of(spec: dict, cell: str, kind: str):
    """The ``kind`` ("end_to_end" or "per_layer") metrics the cell
    reports: those that list it, and those that list no cells."""
    return [m for m in spec[kind] if cell in m.get("workloads", [cell])]


def forbidden_modules():
    """Top-level names of loaded modules that are the JAX package or JAX
    itself, compared whole."""
    return sorted({k.split(".", 1)[0] for k in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit_w():
    """The card's power limit from ``nvidia-smi``, or ``None``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def parse(argv):
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def prepare_torch(root: Path):
    """Caches inside the checkout at fixed paths, float32 without TF32,
    few host threads. Returns ``torch``."""
    build = root / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(min(4, torch.get_num_threads()))
    return torch


class Clock:
    """A call's time: CUDA events on the card, the host clock on the CPU
    (where only the tests run)."""

    def __init__(self, torch, device):
        self.torch, self.cuda = torch, device.type == "cuda"

    def time(self, fn):
        if self.cuda:
            a = self.torch.cuda.Event(enable_timing=True)
            b = self.torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            return a.elapsed_time(b)
        t = time.perf_counter()
        fn()
        return (time.perf_counter() - t) * 1e3

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()


def trace_slice(system, torch, device, k: int, n: int):
    """Calls ``k`` to ``k + 2 n - 1`` under the profiler, the last ``n``
    traced (``trace.profile_calls``). Returns the traced calls, the
    trace's summary (``None`` on the CPU, which the profiler does not
    trace for the card) and what the system counted over them."""
    calls = list(range(k, k + 2 * n))
    active = calls[n:]
    it = iter(calls)

    def one():
        kk = next(it)
        if kk == active[0] and hasattr(system, "trace_begin"):
            system.trace_begin()
        system.call(kk)
    summary = None
    if device.type == "cuda":
        summary = trace_mod.profile_calls(torch, one, n)
    else:
        for _ in calls:
            one()
    counted = system.trace_end() if hasattr(system, "trace_end") else None
    return dict(calls=active, summary=summary, counted=counted)


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, t0: float, device=None, require_chip=True,
             config_overrides=None, mix_overrides=None):
    """One run. Returns the result object; raises ``RunError`` where the
    run may not print one."""
    spec = load_json(root / "BENCHMARK.json")
    cell, conf = lookup(spec, workload)
    bench = root / "bench"
    config = load_json(root / conf["file"])
    config.update(config_overrides or {})
    mix = load_json(bench / "mixes" / f"{cell['traffic']}.json")
    mix.update(mix_overrides or {})
    torch = prepare_torch(root)
    module = load_module(Path(root / conf["file"]).with_suffix(".py"),
                         "bench_config_" + conf["name"].replace("-", "_"))
    if require_chip:
        if not torch.cuda.is_available():
            raise RunError("no CUDA device: the benchmark runs on the card")
        if torch.cuda.device_count() < int(cell["chips"]):
            raise RunError(f"the cell needs {cell['chips']} cards, "
                           f"{torch.cuda.device_count()} present")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    clock = Clock(torch, device)
    ctx = SimpleNamespace(torch=torch, device=device, seed=seed,
                          config=config, mix=mix)

    t_built = time.perf_counter()
    system = module.setup(ctx)
    clock.sync()
    t_made = time.perf_counter()
    system.warmup()
    clock.sync()
    setup_s = time.perf_counter() - t0
    eprint(f"setup_s {setup_s:.3f}: imports "
           f"{t_built - t0:.3f}, the card, inputs and system "
           f"{t_made - t_built:.3f}, "
           f"warm-up {t0 + setup_s - t_made:.3f}")

    before = system.counters() if hasattr(system, "counters") else {}
    times, traced, k = [], None, 0
    start = time.perf_counter()
    while True:
        if (trace and traced is None
                and time.perf_counter() - start >= TRACE_AT * seconds):
            n_tr = int(mix["trace_calls"])
            traced = trace_slice(system, torch, device, k, n_tr)
            k += 2 * n_tr
        else:
            times.append(clock.time(lambda: system.call(k)))
            k += 1
        if time.perf_counter() - start >= seconds:
            break
    clock.sync()
    window_s = time.perf_counter() - start
    eprint(f"window {window_s:.3f} s: {k} calls, {len(times)} timed; call ms "
           f"median {np.median(times):.3f}, max {max(times):.3f}; "
           f"{window_s - sum(times) / 1e3:.3f} s outside the timed calls")
    after = system.counters() if hasattr(system, "counters") else {}
    for key in after:
        eprint(f"{key} over the window: {(after[key] - before[key]).tolist()}")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    out = {}
    if not trace:
        values = {"setup_s": setup_s,
                  module.CALL_METRIC: float(np.percentile(times, 95)),
                  module.RATE_METRIC: system.units_per_call * k / window_s}
        for m in metrics_of(spec, workload, "end_to_end"):
            out[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    run = SimpleNamespace(system=system, trace=traced,
                          peaks=peaks_mod.peaks_for(name),
                          counters=(before, after))
    for m in metrics_of(spec, workload, "per_layer") if trace else ():
        reader = load_module(bench / "metrics" / f"{m['name']}.py",
                             "bench_metric_" + m["name"].replace(".", "_"))
        v = reader.read(run)
        if v is None:
            eprint(f"per-layer {m['name']}: nothing to read")
            continue
        out[m["name"]] = {"value": v, "unit": m["unit"]}
    system.release()
    t_check = time.perf_counter()
    readings, failed, missing = system.check()
    eprint(f"reference comparison {time.perf_counter() - t_check:.3f} s")
    correct = (failed == 0 and missing == 0
               and all(v <= lim for v, lim in readings.values()))

    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": name, "count": int(cell["chips"]),
           "memory_peak_bytes": int(peak),
           "power_limit_w": (power_limit_w() if device.type == "cuda"
                             else None)}
    result = {"correct": bool(correct), "attempted": int(k),
              "failed": int(failed + missing), "metrics": out, "device": dev}
    if trace and traced is not None and traced["summary"] is not None:
        s = traced["summary"]
        dev["busy_s"], dev["window_s"] = s["busy_s"], s["window_s"]
        result["breakdown"] = {"device_ops": trace_mod.top(s["ops"]),
                               "idle_gaps": trace_mod.top(s["gaps"])}
        # each kernel's own roofline share: ``main`` prints it on a line
        # of its own before the result
        result["kernel_roofline_shares"] = getattr(run, "kernel_shares", None)
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, (v, lim) in readings.items()}
    return result


def main(argv, t0: float, root: Path) -> int:
    args = parse(argv)
    try:
        result = run_cell(root, args.workload, args.seed, args.seconds,
                          bool(args.trace), t0)
    except RunError as e:
        eprint(f"bench: {e}")
        return 2
    # the window has closed: this process must not have loaded JAX or the
    # JAX package (top-level names compared whole: ``repro_torch`` is not
    # ``repro``)
    found = forbidden_modules()
    if found:
        eprint(f"bench: modules of JAX or the JAX package loaded: {found}")
        return 2
    shares = result.pop("kernel_roofline_shares", None)
    if shares:
        print("kernel_roofline_shares " + json.dumps(shares), flush=True)
    for n, c in result["checks"].items():
        eprint(f"check {n} = {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0
