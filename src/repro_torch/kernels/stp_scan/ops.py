"""Wrapper of the stp_scan kernel (``csrc/stp_scan.cu``): the STP efficacy
trajectory of a whole window in one launch.

``stp_scan(r0, spikes_t, scale, u=..., recovery=...)`` returns the
efficacies of every step and the final resources, as the loop of
``stp.efficacy`` and ``stp.update`` steps gives them (``ref.py``). An
instance prefix folds into one N axis; the spikes are read through their
strides and the scale broadcasts over the prefix. CPU tensors run the
plain version; CUDA tensors launch the kernel, built without multiply-add
contraction, which repeats the plain version's operations in order and
matches it bit for bit, or raise.
"""
from __future__ import annotations

import math

import torch

from repro_torch import kernels
from repro_torch.analysis import cost
from repro_torch.kernels.stp_scan.ref import stp_scan_ref

EFF_MAX = 1.5     # stp.efficacy's clamp
R_MAX = 1.0       # stp.update's clamp


def work(T: int, N: int, R: int) -> cost.Work:
    """One window's work at [T, N, R]: the spikes read and the efficacies
    written (4 bytes each), r0, the scale and r_T; 14 operations a step
    and lane."""
    return cost.Work(flops=14.0 * T * N * R,
                     bytes=float(2 * T * N * R * 4 + 3 * N * R * 4))


def stp_scan(r0, spikes_t, scale, *, u: float, recovery: float):
    """r0 [*prefix, R] float32; spikes_t [T, *prefix, R] float32; scale
    float32 broadcastable to [*prefix, R]. ``u`` and ``recovery`` are
    Python floats (float32 values, as the plain version takes them).
    Returns (eff_t [T, *prefix, R], r_T [*prefix, R])."""
    if cost.ACTIVE is not None:
        return cost.kernel_call(
            "stp_scan", work(spikes_t.shape[0], math.prod(r0.shape[:-1]),
                             r0.shape[-1]), stp_scan, r0, spikes_t, scale,
            u=u, recovery=recovery)
    if r0.device.type == "cpu":
        return stp_scan_ref(r0, spikes_t, scale, u=u, recovery=recovery)
    from repro_torch.kernels import _build
    dev = r0.device
    if dev.type != "cuda":
        raise ValueError(f"stp_scan: unsupported device {dev}")
    prefix, R = tuple(r0.shape[:-1]), r0.shape[-1]
    T = spikes_t.shape[0]
    N = math.prod(prefix)
    if tuple(spikes_t.shape[1:]) != tuple(r0.shape):
        raise ValueError(f"stp_scan: spikes {tuple(spikes_t.shape)} do not "
                         f"match r0 {tuple(r0.shape)}")
    for name, x in (("r0", r0), ("spikes_t", spikes_t), ("scale", scale)):
        if x.device != dev or x.dtype != torch.float32:
            raise ValueError(f"stp_scan: {name} must be float32 on {dev}")
    r = r0.reshape(N, R).contiguous()
    sp = spikes_t.reshape(T, N, R)
    sc = torch.broadcast_to(scale, r0.shape).reshape(N, R)
    eff = torch.empty((T, N, R), dtype=torch.float32, device=dev)
    r_out = torch.empty((N, R), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.lib().stp_scan_launch(
        r.data_ptr(), sp.data_ptr(), sc.data_ptr(), eff.data_ptr(),
        r_out.data_ptr(), T, N, R, sp.stride(0), sp.stride(1), sp.stride(2),
        sc.stride(0), sc.stride(1), float(u), float(recovery), EFF_MAX,
        R_MAX, stream)
    _build.check(err, "stp_scan")
    kernels.LAUNCHES["stp_scan"] += 1
    return eff.reshape(T, *prefix, R), r_out.reshape(r0.shape)
