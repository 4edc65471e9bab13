"""Monte-Carlo calibration (paper §3.2.2, Fig. 4).

The synapse-driver STP circuit has a mismatch-induced efficacy offset per
driver; a 4-bit trim code is found pre-tapeout by binary search on
simulated virtual instances, and the same routine later calibrates
silicon (``repro/verif/calibration.py``):

  * ``measure_stp_offset`` is the teststand testbench — drive a driver
    with a spike train and extract the efficacy offset from the first
    pulse's amplitude;
  * ``binary_search_calibrate`` is the generic per-element code search;
  * ``calibrate_stp`` gives the Fig. 4 before/after spreads.

Everything runs on the device of the offsets given; the search's rounds
are a host loop over device operations with no read back to the host.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.configs.bss2 import BSS2Config
from repro_torch.core import stp


def measure_stp_offset(cfg: BSS2Config, stp_offset, calib_code,
                       n_spikes: int = 5, isi: float = 50.0):
    """Testbench: an equidistant spike train into the drivers; the first
    pulse's efficacy, normalized by the nominal u, gives the offset.

    stp_offset / calib_code: [...] tensors (any shape of virtual drivers).
    Returns the measured offset, same shape.
    """
    state = stp.init_state(stp_offset.shape, stp_offset.device)
    spikes = torch.ones_like(stp_offset, dtype=torch.float32)
    amps = []
    for _ in range(n_spikes):
        amps.append(stp.efficacy(state, spikes, u=cfg.stp_u,
                                 offset=stp_offset, calib_code=calib_code))
        state = stp.update(state, spikes, u=cfg.stp_u,
                           tau_rec=cfg.stp_tau_rec, dt=isi)
    return amps[0] / cfg.stp_u - 1.0


def binary_search_calibrate(measure: Callable, bits: int, shape, device,
                            target: float = 0.0, increasing: bool = False):
    """Bitwise per-element binary search over an integer code.

    measure(code: int32 tensor of ``shape``) -> value tensor of ``shape``.
    Finds, per element, the code whose measured value is closest to
    ``target`` from above. ``increasing``: whether the measured value
    increases with the code.
    """
    code = torch.zeros(shape, dtype=torch.int32, device=device)
    for bit in reversed(range(bits)):
        trial = code + (1 << bit)
        val = measure(trial)
        accept = (val < target) if increasing else (val > target)
        code = torch.where(accept, trial, code)
    return code


def calibrate_stp(cfg: BSS2Config, stp_offset
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Per-driver trim codes for the offsets ``stp_offset``; returns
    ``(codes, metrics)`` with the offsets before (mid-scale code) and
    after, their population standard deviations and the largest |after|
    (the Fig. 4 numbers), all tensors on the offsets' device."""
    def measure(code):
        return measure_stp_offset(cfg, stp_offset, code)

    codes = binary_search_calibrate(measure, cfg.calib_bits,
                                    stp_offset.shape, stp_offset.device,
                                    target=0.0, increasing=False)
    before = measure_stp_offset(
        cfg, stp_offset, torch.full(stp_offset.shape,
                                    2 ** (cfg.calib_bits - 1),
                                    dtype=torch.int32,
                                    device=stp_offset.device))
    after = measure_stp_offset(cfg, stp_offset, codes)
    return codes, dict(
        before=before, after=after,
        std_before=torch.std(before, correction=0),
        std_after=torch.std(after, correction=0),
        max_abs_after=after.abs().max())
