"""What the span readers share: the summary of the program's own
``PhaseTimer`` (``repro_torch.obs.timing``), which ``make_experiment``
keeps as ``meta["timer"]`` and fills as the calls run (spans around a
``scanned_training`` call's load, replays and clones, and regions of the
call's last trial timed by event-record nodes inside its captured trial
graph). A program without that timer reads nothing."""
from __future__ import annotations


def program_spans(run):
    """The experiment timer's ``summary()`` on a CUDA run, or ``None``: on
    the CPU, where the spans time the host, or where the program keeps no
    timer."""
    meta = getattr(run.system, "meta", None) or {}
    timer = meta.get("timer")
    if timer is None or timer.device.type != "cuda":
        return None
    return timer.summary()


def span_mean_ms(run, name: str):
    """The mean of span ``name`` in ms, or ``None`` where it has no
    samples."""
    s = program_spans(run)
    if s is None or "mean_us" not in s.get(name, {}):
        return None
    return s[name]["mean_us"] * 1e-3
