"""Wrapper of the census kernel (``csrc/census.cu``): the event-sparse
route's gate on the device.

``census`` takes a time-major window ``[T, ..., R]`` of efficacies and
returns an int32 ``[3]`` tensor on its device: ``(fits, n_events,
k_max)``, the census of ``core.events.window_stats`` (the worst instance
of the prefix) and ``events.census_fits`` on it. Its first element is the
flag the two route kernels read (``synray_sparse`` runs where it is 1,
``synray`` where it is 0), so the route is taken with no read back to the
host. ``routes``, an int64 ``[2]`` tensor (dense, sparse) on the same
device, gets the decision added. CPU tensors run the plain version
(``ref.py``); CUDA tensors launch the kernel, which reads the window
through its strides (a Dale half in place), or raise.
"""
from __future__ import annotations

import math

import torch

from repro_torch import kernels
from repro_torch.analysis import cost
from repro_torch.kernels.census.ref import census_ref

# one ticket per device: the kernel's last block finds itself by it and
# leaves it at 0 (launches on one stream at a time)
_TICKETS = {}


def work(T: int, N: int, R: int, row_stride: int = 1) -> cost.Work:
    """One census's work over a [T, N, R] window read with a row stride
    of ``row_stride`` (a Dale half in place: 2): every 32-byte sector of
    the efficacy plane it spans, the census out; one test an event."""
    return cost.Work(flops=float(T * N * R),
                     bytes=float(T * N * R * row_stride * 4 + 12))


def census(row_events_t, max_events: int, k_cap: int, routes=None):
    """row_events_t [T, ..., R] float32 -> int32 [3] (fits, n_events,
    k_max); adds the decision to ``routes`` [dense, sparse] if given."""
    if cost.ACTIVE is not None:
        return cost.kernel_call(
            "census", work(row_events_t.shape[0],
                           math.prod(row_events_t.shape[1:-1]),
                           row_events_t.shape[-1], row_events_t.stride(-1)),
            census, row_events_t, max_events, k_cap, routes)
    if row_events_t.device.type == "cpu":
        out = census_ref(row_events_t, max_events, k_cap)
        if routes is not None:
            routes += torch.stack([1 - out[0], out[0]]).to(routes.dtype)
        return out
    from repro_torch.kernels import _build
    dev = row_events_t.device
    if dev.type != "cuda":
        raise ValueError(f"census: unsupported device {dev}")
    if row_events_t.dtype != torch.float32:
        raise ValueError("census: the window must be float32")
    if routes is not None and not (routes.device == dev
                                   and routes.dtype == torch.int64
                                   and routes.shape == (2,)
                                   and routes.is_contiguous()):
        raise ValueError(f"census: routes must be a contiguous int64 [2] "
                         f"tensor on {dev}")
    T, R = row_events_t.shape[0], row_events_t.shape[-1]
    N = math.prod(row_events_t.shape[1:-1])
    ev = row_events_t.reshape(T, N, R)
    ticket = _TICKETS.get(dev)
    if ticket is None:
        ticket = _TICKETS[dev] = torch.zeros(1, dtype=torch.int32,
                                             device=dev)
    # the flag and the census, then (8-byte aligned) the blocks' partial
    # counts
    buf = torch.empty(4 + 2 * max(N, 1) * max(T, 1), dtype=torch.int32,
                      device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.lib().census_launch(
        ev.data_ptr(), T, N, R, ev.stride(0), ev.stride(1), ev.stride(2),
        int(max_events), int(k_cap), buf[4:].data_ptr(), ticket.data_ptr(),
        buf.data_ptr(), None if routes is None else routes.data_ptr(),
        stream)
    _build.check(err, "census")
    kernels.LAUNCHES["census"] += 1
    return buf[:3]
