"""Column-parallel ADC (CADC) model (paper §2.2).

Digitizes analog observables column-parallel at 8 bit, with per-column
offset and gain mismatch — the quantities the PPU actually sees.
``torch.round`` rounds half to even, like ``jnp.round``, so codes agree
with the reference given the same float input.
"""
from __future__ import annotations

import torch


def digitize(x, *, offset, gain, bits: int = 8, in_scale: float = 1.0):
    """x: [..., C] or [..., R, C] analog value; offset/gain: [..., C].

    Returns int32 codes in [0, 2^bits - 1].
    """
    lsb = 2 ** bits - 1
    code = x * (gain * in_scale) + offset
    return torch.clamp(torch.round(code), 0, lsb).to(torch.int32)
