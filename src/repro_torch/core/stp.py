"""Short-term plasticity in the synapse drivers (paper §2.1).

Tsodyks-Markram presynaptic model: on each presynaptic event the available
resource R is partially used (utilization u) and the synaptic current
pulse is scaled accordingly; R recovers with tau_rec. A mismatch-induced
*efficacy offset* per driver models the Fig.-4 distribution; a 4-bit
calibration code trims it. Op trees follow ``repro/core/stp.py``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class STPState(NamedTuple):
    r: torch.Tensor   # available resources in [0, 1], per driver row [..., R]


def init_state(shape, device) -> STPState:
    return STPState(r=torch.ones(shape, dtype=torch.float32, device=device))


CALIB_BITS = 4
# Efficacy units per calibration LSB: the 4-bit trim range (±0.8) covers
# ~3.2 sigma of the offset distribution (sigma_stp_offset = 0.25).
CALIB_STEP = 0.1


def efficacy_scale(offset, calib_code):
    """The loop-invariant per-row factor of ``efficacy`` (the calibrated
    mismatch term). Hoisting it out of a scan keeps the op tree, so it is
    bit-exact."""
    trim = (calib_code.to(torch.float32) - 2 ** (CALIB_BITS - 1)) * CALIB_STEP
    return 1.0 + offset - trim


def efficacy(state: STPState, spikes, *, u: float, offset=None,
             calib_code=None, scale=None):
    """Efficacy of this step's events (0 where no spike)."""
    if scale is None:
        scale = efficacy_scale(offset, calib_code)
    eff = u * state.r * scale
    return torch.clamp(eff, 0.0, 1.5) * spikes


def recovery_factor(tau_rec: float, dt: float) -> float:
    """The loop-invariant recovery increment of ``update``, as the float32
    value the reference computes (``1 - exp(-dt/tau_rec)`` in float32).
    It is evaluated once on the host so that every device multiplies by
    the same bits."""
    e = torch.exp(torch.tensor(-dt / tau_rec, dtype=torch.float32))
    return float(1.0 - e)


def update(state: STPState, spikes, *, u: float, tau_rec: float = None,
           dt: float = None, recovery: float = None) -> STPState:
    """Resource dynamics: use on spike, recover with tau_rec."""
    if recovery is None:
        recovery = recovery_factor(tau_rec, dt)
    r = state.r + (1.0 - state.r) * recovery
    r = r - u * r * spikes
    return STPState(r=torch.clamp(r, 0.0, 1.0))
