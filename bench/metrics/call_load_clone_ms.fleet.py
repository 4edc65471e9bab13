"""Device time a ``scanned_training`` call spends outside its replays, in
ms: loading the state and draws into the loop (``scan.load``) and cloning
the returned state and histories (``scan.clones``), summed over every call
of the run (the warm-up's included) over the calls (``scan.calls``)."""
from harness.spans import program_spans


def read(run):
    s = program_spans(run)
    if s is None or not all(k in s for k in ("scan.load", "scan.clones",
                                             "scan.calls")):
        return None
    total_us = s["scan.load"]["total_us"] + s["scan.clones"]["total_us"]
    return total_us * 1e-3 / s["scan.calls"]["count"]
