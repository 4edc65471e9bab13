"""The traced slice of a ``--trace 1`` run: ``torch.profiler`` (CPU and
CUDA activities) over a few calls in the middle of the window, after as
many in the profiler's warm-up step, reduced to what the per-layer
readers need: the traced window, the device's busy time (the union of
its kernel, copy and set intervals), device time by operation name, and
the idle gaps named by what the host was doing in them. The chrome trace
is written to a temporary directory, read and deleted."""
from __future__ import annotations

import json
import re
import tempfile
from pathlib import Path

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the longest gaps named by the host activity at their middle; the rest
# are summed unnamed
NAMED_GAPS = 500
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver",
             "python_function")


def op_name(name: str) -> str:
    """A device operation's name without ``void``, anonymous namespaces
    and its argument list, at most 90 characters."""
    name = re.sub(r"^void ", "", name.replace("(anonymous namespace)::", ""))
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name[:90]


def profile_calls(torch, call, n: int):
    """Run ``call()`` ``2 n`` times under the profiler, the first ``n`` in
    its warm-up step, each step from a synchronised start to a
    synchronised end. Returns the summary of the active step
    (``summarise``), or ``None`` where the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(
                         str(path))) as prof:
            for _ in range(2):
                torch.cuda.synchronize()
                for _ in range(n):
                    call()
                torch.cuda.synchronize()
                prof.step()
        return summarise(json.loads(path.read_text()))


def summarise(trace: dict):
    """The reduction of one chrome trace: ``window_s`` (first event start
    to last event end, the profiler's own span left out), ``busy_s``,
    ``ops`` {name: [seconds, count]} of every device operation, and
    ``gaps`` {host activity: seconds} of the idle gaps between device
    intervals, the longest ``NAMED_GAPS`` each named by the innermost host
    event at its middle."""
    events = [e for e in trace.get("traceEvents", ())
              if e.get("ph") == "X" and "dur" in e
              and e.get("cat") != "Trace"]
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e)
                 for e in events
                 if str(e.get("cat", "")).lower() in DEVICE_CATS)
    if not dev:
        return None
    start = min(float(e["ts"]) for e in events)
    end = max(float(e["ts"]) + float(e["dur"]) for e in events)
    merged = []
    for a, b, _ in dev:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    ops = {}
    for a, b, e in dev:
        name = op_name(e["name"])
        t, c = ops.get(name, (0.0, 0))
        ops[name] = (t + (b - a) * 1e-6, c + 1)
    host = [e for e in events
            if str(e.get("cat", "")).lower() in HOST_CATS]
    hs = np.asarray([float(e["ts"]) for e in host])
    he = hs + np.asarray([float(e["dur"]) for e in host])
    bounds = [(start, start)] + [tuple(m) for m in merged] + [(end, end)]
    spans = sorted(((b - a, a, b) for (_, a), (b, _) in zip(bounds,
                                                            bounds[1:])
                    if b > a), reverse=True)
    gaps = {}
    for k, (d, a, b) in enumerate(spans):
        name = "shorter gaps"
        if k < NAMED_GAPS and len(host):
            mid = 0.5 * (a + b)
            inside = np.nonzero((hs <= mid) & (he >= mid))[0]
            name = "host idle"
            if len(inside):
                name = op_name(host[inside[np.argmin(
                    he[inside] - hs[inside])]]["name"])
        gaps[name] = gaps.get(name, 0.0) + d * 1e-6
    return dict(window_s=(end - start) * 1e-6, busy_s=busy * 1e-6,
                ops={k: list(v) for k, v in ops.items()}, gaps=gaps)


def top(d: dict, n: int = 10):
    """The ``n`` largest entries of {name: seconds or [seconds, count]} as
    [[name, seconds], ...]."""
    items = [(k, v[0] if isinstance(v, (list, tuple)) else v)
             for k, v in d.items()]
    return [[k, v] for k, v in sorted(items, key=lambda kv: -kv[1])[:n]]
