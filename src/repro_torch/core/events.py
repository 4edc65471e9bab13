"""Event records for the event-sparse synaptic path.

The packing layer of the sparse route (``repro_torch.kernels.
synray_sparse``): a window's [N, T, R] row events and per-row event
addresses become a per-step [N, T, K] grid of ``(row, addr, efficacy)``
records, rows ascending within a step, the order the sparse kernel needs
to sum like the dense one; and the window census the route's gate decides
on.

The grid equals the reference's ``pack_events`` followed by
``regroup_events`` (``repro/core/events.py``) value for value, drops
included, but is built without the intermediate stream: which records a
stream keeps is one predicate (``stream_keep``), shared with the wafer
router's compact link transport, whose delivered grid is its input grid
where that predicate holds (the reference's ``pack_events_batch`` ->
``truncate_stream`` -> ``unpack_events_batch``). Records are int32 like
the reference's. PyTorch has no ``mode="drop"`` scatter,
so the scatter writes into the capacity plus one dump slot and slices the
dump slot off.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

_I32 = torch.int32


def _scatter(n_slots: int, dst, src):
    """``zeros(n_slots).at[dst].set(src, mode="drop")`` over the last
    axis: ``dst == n_slots`` is the dump slot. ``dst`` [..., M] int64,
    ``src`` [..., M]."""
    out = torch.zeros((*dst.shape[:-1], n_slots + 1), dtype=src.dtype,
                      device=src.device)
    return out.scatter_(-1, dst, src)[..., :n_slots]


def census_fits(n_events, k_max, max_events: int, k_cap: int):
    """The shared no-drop predicate: a window whose event census is
    ``(n_events, k_max)`` packs AND regroups losslessly into capacities
    ``(max_events, k_cap)``."""
    return (n_events <= max_events) & (k_max <= k_cap)


def window_stats(row_events_t) -> Tuple[torch.Tensor, torch.Tensor]:
    """(worst per-instance event count, worst per-instance-step count) of
    a [T, .., R] window, as int32 device scalars: the census the sparse
    gate decides on, for the worst instance of the prefix. A window of no
    step (T = 0) has the census (0, 0)."""
    fired = (row_events_t != 0.0).to(_I32)
    per_step = fired.sum(-1, dtype=_I32)                 # [T, ..]
    if per_step.numel() == 0:
        # a window of no step: no event (0 is where both maxima of counts
        # start)
        z = per_step.new_zeros(())
        return z, z.clone()
    return per_step.sum(0, dtype=_I32).max(), per_step.max()


def stream_keep(fired, max_events: int, k_cap: int):
    """Which fired slots of [N, T, R] windows a capacity-``max_events``
    t-major stream keeps when each step keeps at most ``k_cap`` of its
    records: the slot fired, its t-major ordinal is below ``max_events``
    and its rank within its step below ``k_cap``. Returns ``(keep,
    rank)``, the [N, T, R] bool mask and the int64 rank of each slot
    within its step. The records the first ``max_events`` keep are a
    prefix of each step's records, so the rank among all records of the
    step is the rank among the kept ones: the mask is the reference's
    ``pack_events`` followed by ``regroup_events`` (``k_cap`` slots a
    step) or by ``truncate_stream`` (``k_cap`` records a step) alike."""
    N, T, R = fired.shape
    rank = torch.cumsum(fired, dim=-1) - 1
    ordinal = (torch.cumsum(fired.reshape(N, T * R), dim=-1) - 1
               ).reshape(N, T, R)
    return fired & (ordinal < max_events) & (rank < k_cap), rank


def regroup_window(row_events_ntr, event_addr_ntr, max_events: int,
                   k_cap: int):
    """[N, T, R] windows -> the [N, T, K] record grids of the
    reference's ``regroup_events(pack_events(...))`` per instance, value
    for value (drops included), built without the intermediate stream:
    the records ``stream_keep`` keeps, in their slots. Returns int32 rows
    and addresses and float32 efficacies."""
    N, T, R = row_events_ntr.shape
    eff = row_events_ntr.to(torch.float32)
    keep, rank = stream_keep(eff != 0.0, max_events, k_cap)
    t_idx = torch.arange(T, device=eff.device).reshape(1, T, 1)
    dst = torch.where(keep, t_idx * k_cap + rank, T * k_cap
                      ).reshape(N, T * R)
    rows = torch.arange(R, dtype=_I32, device=eff.device).expand(N, T, R)
    shape = (N, T, k_cap)
    return (_scatter(T * k_cap, dst, rows.reshape(N, T * R)).reshape(shape),
            _scatter(T * k_cap, dst, event_addr_ntr.to(_I32).reshape(
                N, T * R)).reshape(shape),
            _scatter(T * k_cap, dst, eff.reshape(N, T * R)).reshape(shape))


def default_max_events(T: int, R: int, threshold: float) -> int:
    """Stream capacity implied by a density threshold (rounded up to a
    multiple of 8): the capacity IS the density gate."""
    cap = int(math.ceil(threshold * T * R))
    return max(32, min(T * R, ((cap + 7) // 8) * 8))


def default_k_cap(R: int, threshold: float) -> int:
    """Per-step record capacity: a Bernoulli(threshold) row census with
    generous Poisson headroom."""
    cap = int(math.ceil(4.0 * threshold * R)) + 4
    return max(8, min(R, ((cap + 3) // 4) * 4))
