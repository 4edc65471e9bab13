"""Wrapper of the corr kernel (``csrc/corr.cu``).

Spike windows are time-major ([T, ..., R] / [T, ..., C]); an instance
prefix on the sensor state folds into one N axis. CPU tensors run the
plain per-step version (``ref.py``); CUDA tensors launch the kernel,
which keeps the accumulators in registers for the whole window and
updates them only at the steps where a spike touches them (the skip is
exact; the conditions are in ``corr.cu``'s header): it matches the plain
version bit for bit on finite inputs.
"""
from __future__ import annotations

import math

import torch

from repro_torch import kernels
from repro_torch.analysis import cost
from repro_torch.kernels.corr.ref import correlation_window_ref


def work(T: int, N: int, R: int, C: int) -> cost.Work:
    """One window's work at [T, N, R, C]: the spike windows and the traces
    read, the two accumulators read and written; a step's two trace
    updates and, for every synapse, a multiply, an add and a min on each
    accumulator (the plain version's arithmetic; the kernel skips the
    steps no spike touches)."""
    return cost.Work(flops=float(T * N * (2 * (R + C) + 6 * R * C)),
                     bytes=float((T * N * (R + C) + 2 * N * (R + C)
                                  + 4 * N * R * C) * 4))


def correlation_window(pre_t, post_t, tp0, tq0, ac0, aa0, *, lam: float,
                       sat: float = 1023.0):
    """Returns (a_causal, a_acausal, tp, tq)."""
    if cost.ACTIVE is not None:
        R, C = ac0.shape[-2:]
        return cost.kernel_call(
            "corr", work(pre_t.shape[0], math.prod(ac0.shape[:-2]), R, C),
            correlation_window, pre_t, post_t, tp0, tq0, ac0, aa0, lam=lam,
            sat=sat)
    if ac0.device.type == "cpu":
        return correlation_window_ref(pre_t, post_t, tp0, tq0, ac0, aa0,
                                      lam=lam, sat=sat)
    from repro_torch.kernels import _build
    dev = ac0.device
    if dev.type != "cuda":
        raise ValueError(f"corr: unsupported device {dev}")
    prefix = tuple(ac0.shape[:-2])
    R, C = ac0.shape[-2:]
    T = pre_t.shape[0]
    N = math.prod(prefix)
    want = {"pre_t": (T, *prefix, R), "post_t": (T, *prefix, C),
            "tp0": (*prefix, R), "tq0": (*prefix, C),
            "ac0": (*prefix, R, C), "aa0": (*prefix, R, C)}
    args = dict(pre_t=pre_t, post_t=post_t, tp0=tp0, tq0=tq0, ac0=ac0,
                aa0=aa0)
    for name, x in args.items():
        if tuple(x.shape) != want[name]:
            raise ValueError(f"corr: {name} shape {tuple(x.shape)}, "
                             f"expected {want[name]}")
        if x.device != dev or x.dtype != torch.float32 \
                or not x.is_contiguous():
            raise ValueError(f"corr: {name} must be contiguous float32 on "
                             f"{dev}")
    f32 = dict(dtype=torch.float32, device=dev)
    ac = torch.empty((N, R, C), **f32)
    aa = torch.empty((N, R, C), **f32)
    tp = torch.empty((N, R), **f32)
    tq = torch.empty((N, C), **f32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.lib().corr_launch(
        pre_t.data_ptr(), post_t.data_ptr(), tp0.data_ptr(), tq0.data_ptr(),
        ac0.data_ptr(), aa0.data_ptr(), ac.data_ptr(), aa.data_ptr(),
        tp.data_ptr(), tq.data_ptr(), N, T, R, C, float(lam), float(sat),
        stream)
    _build.check(err, "corr")
    kernels.LAUNCHES["corr"] += 1
    return (ac.reshape(*prefix, R, C), aa.reshape(*prefix, R, C),
            tp.reshape(*prefix, R), tq.reshape(*prefix, C))
