"""What several per-layer readers share: the traced slice's idle share
and the device time of its operations by the port's kernels."""
from __future__ import annotations

from harness import kernel_work


def summary(run):
    """The traced slice's trace summary, or ``None``."""
    return (run.trace or {}).get("summary")


def idle_share_pct(run):
    """The share of the traced window in which no operation ran on the
    device, in percent."""
    s = summary(run)
    if s is None or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def seconds_by_kernel(s):
    """{port kernel or None: device seconds} of a trace summary: the
    port's kernels by name, every other operation under ``None``."""
    out = {}
    for name, (sec, _) in s["ops"].items():
        fam = kernel_work.family(name)
        out[fam] = out.get(fam, 0.0) + sec
    return out
