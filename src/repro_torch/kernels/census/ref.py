"""Plain PyTorch version of the census kernel: the window census of
``core.events.window_stats`` and its no-drop predicate ``census_fits``,
the reference's ``lax.cond`` predicate (``repro/core/synapse.py:250-
251``)."""
import torch

from repro_torch.core import events


def census_ref(row_events_t, max_events: int, k_cap: int):
    """row_events_t [T, N, R] -> int32 [3]: (fits, worst instance's event
    count, worst (instance, step) count)."""
    n, k_max = events.window_stats(row_events_t)
    fits = events.census_fits(n, k_max, max_events, k_cap)
    return torch.stack([fits.to(torch.int32), n, k_max])
