"""Wrapper of the synray_sparse kernel (``csrc/synray_sparse.cu``).

Three entry points; the first two are those of
``repro/kernels/synray_sparse/ops.py``:

``sparse_window``
    The compute on already-regrouped [N, T, K] event records. CPU tensors
    run the plain version (``ref.py``); CUDA tensors launch the kernel's
    record form, which reads the stores through their strides, so the
    Dale halves ``w[:, 0::2, :]`` are not copied, and writes a time-major
    buffer: its [N, T, C] result is a view of a contiguous [T, N, C]
    tensor, the layout the window's consumers (``neuron_scan``) read.

``sparse_current_window``
    The whole event-sparse path on a time-major window ``[T, ..., R]``
    (the route's form): on the card one launch of the kernel's window
    form, which reads the efficacy and address planes through their
    strides (a Dale half in place) and keeps exactly the records that
    ``core.events.regroup_window`` keeps, so no pack runs; on the CPU
    ``regroup_window`` and the plain version. Windows that overflow
    ``max_events`` / ``k_cap`` drop records; callers that cannot prove
    the window fits gate on the census (``kernels.census``), as
    ``core.synapse.synaptic_current_window(sparse="auto")`` does: the
    census's ``flag`` lets the kernel run only where the window fits.
    Windows of more than ``MAX_WINDOW_ROWS`` rows are regrouped into
    records on the card and take the record form.

``synaptic_current_sparse``
    The reference's form of the same path, on folded [N, T, R] windows:
    the window form on a time-major view of them.
"""
from __future__ import annotations

import math

import torch

from repro_torch import kernels
from repro_torch.analysis import cost
from repro_torch.core import events
from repro_torch.kernels.synray_sparse.ref import sparse_window_ref

MAX_WINDOW_ROWS = 4096   # csrc/synray_sparse.cu: 32 x its chunk's units


def _check(cond, msg):
    if not cond:
        raise ValueError(f"synray_sparse: {msg}")


def _check_stores(weights, addresses, dev, N, R, C):
    for name, x in (("weights", weights), ("addresses", addresses)):
        _check(x.device == dev and x.dtype == torch.int8
               and tuple(x.shape) == (N, R, C) and x.stride(2) == 1,
               f"{name} must be int8 [N, R, C] with contiguous columns "
               f"on {dev}")


def _check_flag(flag, dev):
    _check(flag is None or (flag.device == dev and flag.dtype == torch.int32),
           f"flag must be int32 on {dev}")
    return None if flag is None else flag.data_ptr()


def work_window(T: int, N: int, R: int, C: int, max_events: int,
                k_cap: int, row_stride: int = 1) -> cost.Work:
    """The window form's work at [T, N, R, C] with rows read at a stride
    of ``row_stride`` (a Dale half in place: 2): the efficacy and address
    planes as strided reads (every 32-byte sector they span, 5 bytes a
    row), the two int8 stores, the output; an FMA per column for each
    record the capacities keep (at most ``min(max_events, T * k_cap)``
    an instance)."""
    n_rec = min(max_events, T * k_cap)
    return cost.Work(flops=2.0 * N * n_rec * C,
                     bytes=float(T * N * R * row_stride * 5 + 2 * N * R * C
                                 + T * N * C * 4))


def work_records(N: int, T: int, K: int, R: int, C: int) -> cost.Work:
    """The record form's work: the [N, T, K] rows, addresses and
    efficacies read, the two int8 [N, R, C] stores, the [N, T, C]
    output; an FMA per record and column."""
    return cost.Work(flops=2.0 * N * T * K * C,
                     bytes=float(N * T * K * 12 + 2 * N * R * C
                                 + N * T * C * 4))


def sparse_window(rows_tk, addr_tk, eff_tk, weights, addresses, *,
                  flag=None, out=None):
    """out[n, t, c] = sum_k eff[n, t, k] * w[n, rows[n, t, k], c]
    * (addr_store[n, rows[n, t, k], c] == addr[n, t, k]).

    rows_tk/addr_tk [N, T, K] int32, eff_tk [N, T, K] float32,
    weights/addresses [N, R, C] int8 -> [N, T, C] float32. On the card,
    ``flag`` (int32, 1 where the window fits) gates the launch and
    ``out`` ([N, T, C] float32, a view of a contiguous [T, N, C] buffer)
    is written in place."""
    if cost.ACTIVE is not None:
        N, T, K = rows_tk.shape
        return cost.kernel_call(
            "synray_sparse", work_records(N, T, K, *weights.shape[-2:]),
            sparse_window, rows_tk, addr_tk, eff_tk, weights, addresses,
            flag=flag, out=out)
    if eff_tk.device.type == "cpu":
        _check(flag is None and out is None, "flag and out are card-only")
        return sparse_window_ref(rows_tk, addr_tk, eff_tk, weights,
                                 addresses)
    from repro_torch.kernels import _build
    dev = eff_tk.device
    _check(dev.type == "cuda", f"unsupported device {dev}")
    _check(rows_tk.ndim == 3 and weights.ndim == 3,
           f"record operands [N, T, K] and stores [N, R, C], got "
           f"{tuple(rows_tk.shape)} {tuple(weights.shape)}")
    N, T, K = rows_tk.shape
    R, C = weights.shape[1:]
    rec_sn = rows_tk.stride(0)
    for name, x, dt in (("rows_tk", rows_tk, torch.int32),
                        ("addr_tk", addr_tk, torch.int32),
                        ("eff_tk", eff_tk, torch.float32)):
        # each instance's [T, K] block contiguous, one instance stride
        _check(x.device == dev and x.dtype == dt
               and tuple(x.shape) == (N, T, K)
               and x.stride() == (rec_sn, K, 1) and rec_sn >= T * K,
               f"{name} must be {dt} [N, T, K] on {dev} with contiguous "
               f"[T, K] blocks and the instance stride of rows_tk")
    _check_stores(weights, addresses, dev, N, R, C)
    if out is None:
        out = torch.empty((T, N, C), dtype=torch.float32,
                          device=dev).permute(1, 0, 2)
    _check(out.device == dev and out.dtype == torch.float32
           and tuple(out.shape) == (N, T, C) and out.stride(2) == 1,
           f"out must be float32 [N, T, C] on {dev}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.lib().synray_sparse_launch(
        rows_tk.data_ptr(), addr_tk.data_ptr(), eff_tk.data_ptr(),
        weights.data_ptr(), addresses.data_ptr(), out.data_ptr(),
        _check_flag(flag, dev), N, T, K, R, C, rec_sn, weights.stride(0),
        weights.stride(1), addresses.stride(0), addresses.stride(1),
        out.stride(0), out.stride(1), stream)
    _build.check(err, "synray_sparse")
    kernels.LAUNCHES["synray_sparse"] += 1
    return out


def sparse_current_window(events_t, event_addr_t, weights, addresses, *,
                          max_events: int, k_cap: int, flag=None, out=None):
    """events_t [T, ..., R] float32 (0 = silent, else efficacy);
    event_addr_t [T, ..., R] int8; weights/addresses [..., R, C] int8 ->
    [T, ..., C] float32, records beyond the capacities dropped (see the
    module docstring). ``flag`` (the int32 census of ``kernels.census``
    on this window at these capacities) lets it compute only where
    ``flag[0] != 0``, that is where no record is dropped, into ``out`` (a
    contiguous float32 [T, ..., C] tensor) when given."""
    if cost.ACTIVE is not None:
        R, C = weights.shape[-2:]
        return cost.kernel_call(
            "synray_sparse", work_window(
                events_t.shape[0], math.prod(weights.shape[:-2]), R, C,
                max_events, k_cap, events_t.stride(-1)),
            sparse_current_window, events_t, event_addr_t, weights,
            addresses, max_events=max_events, k_cap=k_cap, flag=flag,
            out=out)
    from repro_torch.kernels import (fold_instance, fold_instance_time,
                                     unfold_instance_time)
    T = events_t.shape[0]
    prefix = tuple(weights.shape[:-2])
    R, C = weights.shape[-2:]
    if events_t.device.type == "cpu":
        if flag is not None and int(flag[0]) == 0:
            return out
        recs = events.regroup_window(
            fold_instance_time(events_t.to(torch.float32), 1),
            fold_instance_time(event_addr_t, 1), max_events, k_cap)
        i = unfold_instance_time(sparse_window_ref(
            *recs, fold_instance(weights, 2), fold_instance(addresses, 2)),
            prefix)
        return i if out is None else out.copy_(i)
    from repro_torch.kernels import _build
    dev = events_t.device
    _check(dev.type == "cuda", f"unsupported device {dev}")
    _check(events_t.dtype == torch.float32
           and event_addr_t.dtype == torch.int8
           and events_t.device == event_addr_t.device == dev
           and tuple(events_t.shape) == (T, *prefix, R)
           and tuple(event_addr_t.shape) == (T, *prefix, R),
           f"events float32 and addresses int8 [T, *prefix, R] on {dev}, "
           f"got {tuple(events_t.shape)} {tuple(event_addr_t.shape)}")
    N = math.prod(prefix)
    ev = events_t.reshape(T, N, R)
    ea = event_addr_t.reshape(T, N, R)
    w, a = weights.reshape(N, R, C), addresses.reshape(N, R, C)
    _check_stores(w, a, dev, N, R, C)
    if out is None:
        out = torch.empty((T, *prefix, C), dtype=torch.float32, device=dev)
    _check(out.device == dev and out.dtype == torch.float32
           and tuple(out.shape) == (T, *prefix, C) and out.is_contiguous(),
           f"out must be a contiguous float32 {(T, *prefix, C)} on {dev}")
    o = out.view(T, N, C)
    if R > MAX_WINDOW_ROWS:
        recs = events.regroup_window(ev.permute(1, 0, 2),
                                     ea.permute(1, 0, 2), max_events, k_cap)
        sparse_window(*recs, w, a, flag=flag, out=o.permute(1, 0, 2))
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.lib().synray_sparse_window_launch(
        ev.data_ptr(), ea.data_ptr(), w.data_ptr(), a.data_ptr(),
        o.data_ptr(), _check_flag(flag, dev), N, T, R, C,
        ev.stride(0), ev.stride(1), ev.stride(2),
        ea.stride(0), ea.stride(1), ea.stride(2),
        w.stride(0), w.stride(1), a.stride(0), a.stride(1),
        o.stride(1), o.stride(0), int(max_events), int(k_cap), stream)
    _build.check(err, "synray_sparse")
    kernels.LAUNCHES["synray_sparse"] += 1
    return out


def synaptic_current_sparse(row_events_t, event_addr_t, weights, addresses,
                            *, max_events: int, k_cap: int):
    """row_events_t [N, T, R] float32 (0 = silent, else efficacy);
    event_addr_t [N, T, R] int; weights/addresses [N, R, C] int8
    -> [N, T, C] float32. Drops events beyond the capacities (see the
    module docstring)."""
    i = sparse_current_window(
        row_events_t.permute(1, 0, 2), event_addr_t.permute(1, 0, 2),
        weights, addresses, max_events=max_events, k_cap=k_cap)
    return i.permute(1, 0, 2)
