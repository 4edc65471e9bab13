"""Gradient compression with error feedback (``repro/parallel/
compress.py``).

Int8 quantization with a per-tensor scale; the error-feedback
accumulator re-injects the quantization residual into the next step's
gradient (Seide et al. 1-bit SGD; Karimireddy et al. EF-SGD). The
returned gradients are what every data-parallel group would reconstruct
after a quantized all-reduce. ``torch.round`` rounds half to even, as
``jnp.round`` does.
"""
from __future__ import annotations

import torch

from repro_torch.parallel.sharding import full


def compress(g, bits: int = 8):
    """Per-tensor symmetric int quantization. Returns (q, scale). The
    scale of a sharded leaf (a DTensor) is the max over the whole leaf,
    a replicated 0-d tensor."""
    qmax = 2 ** (bits - 1) - 1
    scale = torch.clamp(full(torch.amax(torch.abs(g))) / qmax, min=1e-20)
    q = torch.clamp(torch.round(g / scale), -qmax, qmax).to(torch.int8)
    return q, scale


def decompress(q, scale):
    return q.float() * scale


def ef_init(params):
    """Zero error-feedback accumulators matching the gradient tree."""
    if isinstance(params, dict):
        return {k: ef_init(v) for k, v in params.items()}
    return torch.zeros_like(params, dtype=torch.float32)


def ef_compress_grads(grads, err, bits: int = 8):
    """Returns (compressed-and-decompressed grads, new error state), trees
    like ``grads``; ``new_err`` carries the residual forward."""
    if isinstance(grads, dict):
        out = {k: ef_compress_grads(grads[k], err[k], bits) for k in grads}
        return ({k: v[0] for k, v in out.items()},
                {k: v[1] for k, v in out.items()})
    g32 = grads.float() + err
    q, s = compress(g32, bits)
    deq = decompress(q, s)
    return deq.to(grads.dtype), g32 - deq
