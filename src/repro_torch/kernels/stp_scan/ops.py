"""Wrapper of the stp_scan kernel (``csrc/stp_scan.cu``): the STP efficacy
trajectory of a window in one launch, in its census form with the sparse
route's gate of both Dale halves taken inside the scan.

``stp_scan(r0, spikes_t, scale, u=..., recovery=...)`` returns the
efficacies of every step and the final resources, as the loop of
``stp.efficacy`` and ``stp.update`` steps gives them (``ref.py``). With
``caps``, each Dale half's capacities ``((max_events, k_cap) of rows
0::2, (max_events, k_cap) of rows 1::2)``, it also returns each half's
census, an int32 ``[3]`` tensor ``(fits, n_events, k_max)`` as
``kernels.census`` gives it for that half, and adds both decisions to
``routes`` (int64 ``[2]``, dense and sparse) if given. An instance prefix
folds into one N axis; the spikes are read through their strides and the
scale broadcasts over the prefix. CPU tensors run the plain version; CUDA
tensors launch the kernel, built without multiply-add contraction, which
repeats the plain version's operations in order and matches it bit for
bit (the censuses are integers), or raise.
"""
from __future__ import annotations

import math

import torch

from repro_torch import kernels
from repro_torch.analysis import cost
from repro_torch.kernels.stp_scan.ref import stp_scan_census_ref, stp_scan_ref

EFF_MAX = 1.5     # stp.efficacy's clamp
R_MAX = 1.0       # stp.update's clamp
_INT_MAX = 2 ** 31 - 1

MAX_ROWS = 256    # rows a block takes; an instance with more spans blocks

# one ticket per device: the census form's last block finds itself by it
# and leaves it at 0 (launches on one stream at a time)
_TICKETS = {}
# per device, the [N, T] step counts the census form sums in where an
# instance spans blocks: int32 at 0 between launches (the kernel leaves
# them so), grown on demand, at least twofold. A CUDA graph captured with
# a launch keeps that launch's buffer address and sums into it on every
# replay, so a grown buffer never frees the one it replaces: each stays
# held (``_HELD``), at most twice the largest in all
_COUNTS = {}
_HELD = []


def work(T: int, N: int, R: int, census: bool = False) -> cost.Work:
    """One window's work at [T, N, R]: the spikes read and the efficacies
    written (4 bytes each), r0, the scale and r_T; 14 operations a step
    and lane. The census form adds one test an element and the two
    censuses out (24 bytes)."""
    return cost.Work(flops=(15.0 if census else 14.0) * T * N * R,
                     bytes=float(2 * T * N * R * 4 + 3 * N * R * 4
                                 + (24 if census else 0)))


def _operands(r0, spikes_t, scale, name):
    dev = r0.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if tuple(spikes_t.shape[1:]) != tuple(r0.shape):
        raise ValueError(f"{name}: spikes {tuple(spikes_t.shape)} do not "
                         f"match r0 {tuple(r0.shape)}")
    for arg, x in (("r0", r0), ("spikes_t", spikes_t), ("scale", scale)):
        if x.device != dev or x.dtype != torch.float32:
            raise ValueError(f"{name}: {arg} must be float32 on {dev}")
    prefix, R = tuple(r0.shape[:-1]), r0.shape[-1]
    T, N = spikes_t.shape[0], math.prod(prefix)
    r = r0.reshape(N, R).contiguous()
    sp = spikes_t.reshape(T, N, R)
    if sp.untyped_storage().data_ptr() % 16:
        sp = sp.clone()   # the kernel's copies start on 16-byte boundaries
    sc = torch.broadcast_to(scale, r0.shape).reshape(N, R)
    eff = torch.empty((T, N, R), dtype=torch.float32, device=dev)
    r_out = torch.empty((N, R), dtype=torch.float32, device=dev)
    return (T, N, R), (r.data_ptr(), sp.data_ptr(), sc.data_ptr(),
                       eff.data_ptr(), r_out.data_ptr(), T, N, R,
                       sp.stride(0), sp.stride(1), sp.stride(2),
                       sc.stride(0), sc.stride(1)), eff, r_out


def stp_scan(r0, spikes_t, scale, *, u: float, recovery: float, caps=None,
             routes=None):
    """r0 [*prefix, R] float32; spikes_t [T, *prefix, R] float32; scale
    float32 broadcastable to [*prefix, R]. ``u`` and ``recovery`` are
    Python floats (float32 values, as the plain version takes them).
    Returns (eff_t [T, *prefix, R], r_T [*prefix, R]); with ``caps``
    (each Dale half's ``(max_events, k_cap)``) also the two censuses
    (rows 0::2, rows 1::2), whose decisions are added to ``routes``."""
    if cost.ACTIVE is not None:
        return cost.kernel_call(
            "stp_scan", work(spikes_t.shape[0], math.prod(r0.shape[:-1]),
                             r0.shape[-1], caps is not None), stp_scan, r0,
            spikes_t, scale, u=u, recovery=recovery, caps=caps,
            routes=routes)
    if r0.device.type == "cpu":
        if caps is None:
            return stp_scan_ref(r0, spikes_t, scale, u=u, recovery=recovery)
        out = stp_scan_census_ref(r0, spikes_t, scale, u=u,
                                  recovery=recovery, caps=caps)
        if routes is not None:
            fits = out[2][0] + out[3][0]
            routes += torch.stack([2 - fits, fits]).to(routes.dtype)
        return out
    from repro_torch.kernels import _build
    (T, N, R), args, eff, r_out = _operands(r0, spikes_t, scale, "stp_scan")
    dev = r0.device
    # no census, capacities, scratch, counts, ticket or routes: the form
    # without
    gate = (None, 0, 0, 0, 0, None, None, None, None)
    if caps is not None:
        (me0, kc0), (me1, kc1) = caps
        if routes is not None and not (routes.device == dev
                                       and routes.dtype == torch.int64
                                       and routes.shape == (2,)
                                       and routes.is_contiguous()):
            raise ValueError(f"stp_scan: routes must be a contiguous int64 "
                             f"[2] tensor on {dev}")
        if N == 0:
            raise ValueError("stp_scan: the census needs an instance")
        ticket = _TICKETS.get(dev)
        if ticket is None:
            ticket = _TICKETS[dev] = torch.zeros(1, dtype=torch.int32,
                                                 device=dev)
        # the two censuses at 0 and 4, then each instance's (sums, maxima)
        buf = torch.empty(8 + 4 * N, dtype=torch.int32, device=dev)
        counts = _COUNTS.get(dev)
        if counts is None or counts.numel() < N * T:
            if counts is not None:
                _HELD.append(counts)
            n = max(N * T, 1, 0 if counts is None else 2 * counts.numel())
            counts = _COUNTS[dev] = torch.zeros(n, dtype=torch.int32,
                                                device=dev)
        gate = (buf.data_ptr(), *(min(int(c), _INT_MAX)
                                  for c in (me0, kc0, me1, kc1)),
                buf[8:].data_ptr(), counts.data_ptr(), ticket.data_ptr(),
                None if routes is None else routes.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.lib().stp_scan_launch(
        *args, float(u), float(recovery), EFF_MAX, R_MAX, *gate, stream)
    _build.check(err, "stp_scan")
    kernels.LAUNCHES["stp_scan"] += 1
    out = (eff.reshape(T, *r0.shape), r_out.reshape(r0.shape))
    if caps is None:
        return out
    return (*out, buf[0:3], buf[4:7])


def block_threads(R: int) -> int:
    """The scan's block: one thread a row of an instance, rounded up to a
    warp, at most MAX_ROWS (more rows take more blocks)."""
    return max(32, -(-min(R, MAX_ROWS) // 32) * 32)


def chain_floor_probe(r0, spikes_t, scale, *, u: float, recovery: float,
                      threads: int = None):
    """A measurement aid on the card, not a window: the recurrence with
    each lane's first 8 spikes in registers and reused in turn, so that no
    memory load sits in the loop and its time is the chain's and the
    stores'. ``threads`` lanes a block over the flattened (instance, row)
    lanes; by default the scan's own block (``block_threads``). Counts no
    launch. Returns (eff_t, r_T) of those spikes."""
    from repro_torch.kernels import _build
    (T, N, R), args, eff, r_out = _operands(r0, spikes_t, scale,
                                            "stp_scan floor")
    stream = torch.cuda.current_stream(r0.device).cuda_stream
    err = _build.lib().stp_scan_floor_launch(
        *args, float(u), float(recovery), EFF_MAX, R_MAX,
        block_threads(R) if threads is None else int(threads), stream)
    _build.check(err, "stp_scan floor")
    return eff.reshape(T, *r0.shape), r_out.reshape(r0.shape)
