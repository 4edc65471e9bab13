"""Host time of the trial graph's capture inside ``setup_s``, in s: the
program's ``graph.capture`` span (``core.graph.LoopGraph``, the capture
proper, after the warm-up body), summed over the run's captures."""
from harness.spans import program_spans


def read(run):
    s = program_spans(run)
    if s is None or "total_us" not in s.get("graph.capture", {}):
        return None
    return s["graph.capture"]["total_us"] * 1e-6
