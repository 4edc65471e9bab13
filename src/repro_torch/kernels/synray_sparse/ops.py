"""Wrapper of the synray_sparse kernel (``csrc/synray_sparse.cu``).

Two entry points, as in ``repro/kernels/synray_sparse/ops.py``:

``sparse_window``
    The compute on already-regrouped [N, T, K] event records. CPU tensors
    run the plain version (``ref.py``); CUDA tensors launch the kernel,
    which reads the stores through their strides, so the Dale halves
    ``w[:, 0::2, :]`` are not copied, and writes a time-major buffer: its
    [N, T, C] result is a view of a contiguous [T, N, C] tensor, the
    layout the window's consumers (``neuron_scan``) read.

``synaptic_current_sparse``
    The whole event-sparse path on folded [N, T, R] windows: regroup the
    window into [N, T, K] records (``core.events.regroup_window``, torch
    ops over all N at once, on the tensors' device), then compute.
    Windows that overflow ``max_events`` / ``k_cap`` drop records; callers
    that cannot prove the window fits gate on ``core.events.window_stats``
    (``core.synapse.synaptic_current_window(sparse="auto")`` does).
"""
from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.core import events
from repro_torch.kernels.synray_sparse.ref import sparse_window_ref


def _check(cond, msg):
    if not cond:
        raise ValueError(f"synray_sparse: {msg}")


def sparse_window(rows_tk, addr_tk, eff_tk, weights, addresses):
    """out[n, t, c] = sum_k eff[n, t, k] * w[n, rows[n, t, k], c]
    * (addr_store[n, rows[n, t, k], c] == addr[n, t, k]).

    rows_tk/addr_tk [N, T, K] int32, eff_tk [N, T, K] float32,
    weights/addresses [N, R, C] int8 -> [N, T, C] float32."""
    if eff_tk.device.type == "cpu":
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
    for name, x in (("weights", weights), ("addresses", addresses)):
        _check(x.device == dev and x.dtype == torch.int8
               and tuple(x.shape) == (N, R, C) and x.stride(2) == 1,
               f"{name} must be int8 [N, R, C] with contiguous columns "
               f"on {dev}")
    out = torch.empty((T, N, C), dtype=torch.float32,
                      device=dev).permute(1, 0, 2)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.lib().synray_sparse_launch(
        rows_tk.data_ptr(), addr_tk.data_ptr(), eff_tk.data_ptr(),
        weights.data_ptr(), addresses.data_ptr(), out.data_ptr(),
        N, T, K, C, rec_sn, weights.stride(0), weights.stride(1),
        addresses.stride(0), addresses.stride(1), out.stride(0),
        out.stride(1), stream)
    _build.check(err, "synray_sparse")
    kernels.LAUNCHES["synray_sparse"] += 1
    return out


def synaptic_current_sparse(row_events_t, event_addr_t, weights, addresses,
                            *, max_events: int, k_cap: int):
    """row_events_t [N, T, R] float32 (0 = silent, else efficacy);
    event_addr_t [N, T, R] int; weights/addresses [N, R, C] int8
    -> [N, T, C] float32. Drops events beyond the capacities (see the
    module docstring)."""
    rows_tk, addr_tk, eff_tk = events.regroup_window(
        row_events_t, event_addr_t, max_events, k_cap)
    return sparse_window(rows_tk, addr_tk, eff_tk, weights, addresses)
