"""Share of the traced slice of a fleet cell in which the device ran
nothing (``torch.profiler``'s device timeline)."""
from harness.readers import idle_share_pct


def read(run):
    return idle_share_pct(run)
