"""Wrapper of the synray kernel (``csrc/synray.cu``).

``synaptic_current`` takes a time-major event window ``[T, ..., R]`` and
an instance-prefixed store ``[..., R, C]`` and returns ``[T, ..., C]``.
CPU tensors run the plain version (``ref.py``); CUDA tensors launch the
kernel, which reads strided operands in place: the Dale halves
``w[..., 0::2, :]`` and event views ``eff_t[..., 0::2]`` are not copied.

``const_addr=True`` promises that each row's event address is the same at
every step of the window; the kernel then reads the addresses of step 0
only and folds the match into its staged weights (the const-address form,
which the main path runs). On the CPU the keyword changes nothing: the
plain version matches every step's address, which on constant addresses
is the same product.

``flag`` (the int32 census of ``kernels.census``, whose first element is 1
where the window fits the sparse route) gates the product on the device:
it runs only where the flag is 0, as the dense branch of the reference's
``lax.cond``; ``out`` (a contiguous float32 [T, ..., C] tensor) is written
in place, so the sparse route's kernel can write the same buffer.
"""
from __future__ import annotations

import math

import torch

from repro_torch import kernels
from repro_torch.analysis import cost
from repro_torch.kernels.synray.ref import synaptic_current_ref


def _check(cond, msg):
    if not cond:
        raise ValueError(f"synray: {msg}")


def work(T: int, N: int, R: int, C: int, const_addr: bool = True
         ) -> cost.Work:
    """One window's work at [T, N, R, C]: the event values, the addresses
    (step 0's in the const-address form, every step's otherwise), the two
    int8 stores and the output; an FMA per step, row and column (the
    plain version's product; the kernel skips rows with no event)."""
    n_addr = N * R if const_addr else T * N * R
    return cost.Work(flops=2.0 * T * N * R * C,
                     bytes=float(T * N * R * 4 + n_addr + 2 * N * R * C
                                 + T * N * C * 4))


def synaptic_current(events_t, event_addr_t, weights, addresses, *,
                     const_addr: bool = False, flag=None, out=None):
    """i[t, ..., c] = sum_r ev[t, ..., r] * w[..., r, c]
    * (addr[..., r, c] == ea[t, ..., r]); with ``const_addr`` the card
    reads ``ea[0, ..., r]`` for every step. With ``flag``, nothing is
    computed where ``flag[0] != 0`` (``out`` is returned as it is)."""
    if cost.ACTIVE is not None:
        R, C = weights.shape[-2:]
        return cost.kernel_call(
            "synray", work(events_t.shape[0], math.prod(weights.shape[:-2]),
                           R, C, const_addr), synaptic_current, events_t,
            event_addr_t, weights, addresses, const_addr=const_addr,
            flag=flag, out=out)
    if events_t.device.type == "cpu":
        if flag is not None and int(flag[0]) != 0:
            return out
        i = synaptic_current_ref(events_t, event_addr_t, weights, addresses)
        return i if out is None else out.copy_(i)
    from repro_torch.kernels import _build
    dev = events_t.device
    _check(dev.type == "cuda", f"unsupported device {dev}")
    for name, x in (("event_addr_t", event_addr_t), ("weights", weights),
                    ("addresses", addresses)):
        _check(x.device == dev, f"{name} on {x.device}, events on {dev}")
    _check(events_t.dtype == torch.float32, "events must be float32")
    for name, x in (("event_addr_t", event_addr_t), ("weights", weights),
                    ("addresses", addresses)):
        _check(x.dtype == torch.int8, f"{name} must be int8")
    T = events_t.shape[0]
    prefix = tuple(weights.shape[:-2])
    R, C = weights.shape[-2:]
    _check(tuple(events_t.shape) == (T, *prefix, R)
           and tuple(event_addr_t.shape) == tuple(events_t.shape)
           and tuple(addresses.shape) == tuple(weights.shape),
           f"shapes {tuple(events_t.shape)} {tuple(event_addr_t.shape)} "
           f"{tuple(weights.shape)} {tuple(addresses.shape)}")
    N = math.prod(prefix)
    ev = events_t.reshape(T, N, R)
    ea = event_addr_t.reshape(T, N, R)
    w = weights.reshape(N, R, C)
    a = addresses.reshape(N, R, C)
    _check(w.stride(2) == 1 and a.stride(2) == 1,
           "weights/addresses need contiguous columns")
    if out is None:
        out = torch.empty((T, *prefix, C), dtype=torch.float32, device=dev)
    _check(out.device == dev and out.dtype == torch.float32
           and tuple(out.shape) == (T, *prefix, C) and out.is_contiguous(),
           f"out must be a contiguous float32 {(T, *prefix, C)} on {dev}")
    _check(flag is None or (flag.device == dev and flag.dtype == torch.int32),
           f"flag must be int32 on {dev}")
    o = out.view(T, N, C)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.lib().synray_launch(
        ev.data_ptr(), ea.data_ptr(), w.data_ptr(), a.data_ptr(),
        o.data_ptr(), None if flag is None else flag.data_ptr(), N, T, R, C,
        ev.stride(1), ev.stride(0), ev.stride(2),
        ea.stride(1), ea.stride(0), ea.stride(2),
        w.stride(0), w.stride(1), a.stride(0), a.stride(1),
        o.stride(1), o.stride(0), int(bool(const_addr)), stream)
    _build.check(err, "synray")
    kernels.LAUNCHES["synray"] += 1
    return out
