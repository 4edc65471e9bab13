"""Wrapper of the ppu_update kernel (``csrc/ppu_update.cu``): the PPU
vector unit's fixed-function R-STDP inner loop (CADC read, eligibility,
weight step, saturating 6-bit store) over [..., R, C] synapses.

An instance prefix folds into one leading N axis; the per-column CADC
offset and gain, the modulator and a fault overlay's CADC map broadcast
to [N, C]. CPU tensors run the plain version (``ref.py``); CUDA tensors
launch the kernel, built without multiply-add contraction, which repeats
the plain version's operations in order and matches it bit for bit.
"""
from __future__ import annotations

import math

import torch

from repro_torch import kernels
from repro_torch.analysis import cost
from repro_torch.kernels.ppu_update.ref import reciprocal, rstdp_update_ref


def work(N: int, R: int, C: int) -> cost.Work:
    """One update's work at [N, R, C]: the int8 weights, the two
    accumulators and xi read, the int8 weights and the float32
    eligibility written (18 bytes a synapse), three [N, C] columns read;
    about 15 operations a synapse."""
    n_syn = N * R * C
    return cost.Work(flops=15.0 * n_syn,
                     bytes=float(18 * n_syn + 3 * 4 * N * C))


def rstdp_update(weights, a_causal, a_acausal, cadc_offset, cadc_gain, mod,
                 xi, *, eta: float, cadc_scale: float = 8.0, wmax: int = 63,
                 cadc_max: int = 255, cadc_map=None):
    """weights [..., R, C] int8; a_causal/a_acausal/xi [..., R, C]
    float32; cadc_offset/cadc_gain/mod [..., C] float32 (broadcast to the
    prefix); ``cadc_map``: ``None`` or the CADC faults' float32 ``(a, lo,
    hi)`` [..., C] (see ``ref.py``). Returns (new weights int8,
    eligibility float32)."""
    if cost.ACTIVE is not None:
        R, C = weights.shape[-2:]
        return cost.kernel_call(
            "ppu_update", work(math.prod(weights.shape[:-2]), R, C),
            rstdp_update, weights, a_causal, a_acausal, cadc_offset,
            cadc_gain, mod, xi, eta=eta, cadc_scale=cadc_scale, wmax=wmax,
            cadc_max=cadc_max, cadc_map=cadc_map)
    if weights.device.type == "cpu":
        return rstdp_update_ref(weights, a_causal, a_acausal, cadc_offset,
                                cadc_gain, mod, xi, eta=eta,
                                cadc_scale=cadc_scale, wmax=wmax,
                                cadc_max=cadc_max, cadc_map=cadc_map)
    from repro_torch.kernels import _build
    dev = weights.device
    if dev.type != "cuda":
        raise ValueError(f"ppu_update: unsupported device {dev}")
    prefix = tuple(weights.shape[:-2])
    R, C = weights.shape[-2:]
    N = math.prod(prefix)
    planes = dict(a_causal=a_causal, a_acausal=a_acausal, xi=xi)
    cols = dict(cadc_offset=cadc_offset, cadc_gain=cadc_gain, mod=mod)
    if cadc_map is not None:
        cols.update(zip(("fault_a", "fault_lo", "fault_hi"), cadc_map))
    if weights.dtype != torch.int8 or not weights.is_contiguous():
        raise ValueError("ppu_update: weights must be contiguous int8")
    for name, x in planes.items():
        if (tuple(x.shape) != tuple(weights.shape) or x.device != dev
                or x.dtype != torch.float32 or not x.is_contiguous()):
            raise ValueError(f"ppu_update: {name} must be contiguous float32 "
                             f"{tuple(weights.shape)} on {dev}")
    for name, x in cols.items():
        if x.device != dev or x.dtype != torch.float32:
            raise ValueError(f"ppu_update: {name} must be float32 on {dev}")
        cols[name] = x.expand(*prefix, C).reshape(N, C).contiguous()
    w_out = torch.empty((N, R, C), dtype=torch.int8, device=dev)
    elig = torch.empty((N, R, C), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.lib().ppu_update_launch(
        weights.data_ptr(), a_causal.data_ptr(), a_acausal.data_ptr(),
        cols["cadc_offset"].data_ptr(), cols["cadc_gain"].data_ptr(),
        cols["mod"].data_ptr(), xi.data_ptr(),
        *((cols[k].data_ptr() if cadc_map is not None else None)
          for k in ("fault_a", "fault_lo", "fault_hi")),
        w_out.data_ptr(),
        elig.data_ptr(), N, R, C, float(eta), float(cadc_scale),
        reciprocal(cadc_max), float(cadc_max), float(wmax), stream)
    _build.check(err, "ppu_update")
    kernels.LAUNCHES["ppu_update"] += 1
    return w_out.reshape(weights.shape), elig.reshape(weights.shape)
