"""Plain PyTorch version of the neuron_scan kernel.

The port of the reference's blocked restructuring
(``repro/kernels/neuron_scan/ref.py``): the synaptic-current states never
read the membrane, so their recurrence runs first over the whole window
and yields the net drive ``i_exc - i_inh``; then the membrane core runs
step by step over that drive, and the rate counters add the summed spikes
once (spikes are {0, 1}, so the float sum is exact in any order). The
reference cut both loops into time blocks to cut XLA's per-iteration
cost; eager PyTorch has no such cost, so the loops are plain. Every step
is ``repro_torch.core.adex``'s op tree, so the result is bit-identical to
scanning ``adex.step``.
"""
from __future__ import annotations

import torch

from repro_torch.core import adex


def neuron_window_ref(state: adex.NeuronState, rate_counters, ie_t, ii_t,
                      params, *, dt: float, use_adex: bool, decays,
                      record_v: bool = False):
    """Integrate a [T, ..., C] current window. Returns ``(new_state,
    rate_counters, recs)`` with ``recs = (spikes_t,)`` or
    ``(spikes_t, v_t)``."""
    T = ie_t.shape[0]
    i_exc, i_inh = state.i_exc, state.i_inh
    drive = []
    for t in range(T):
        i_exc, i_inh = adex.integrate_currents(i_exc, i_inh, ie_t[t],
                                               ii_t[t], decays)
        drive.append(i_exc - i_inh)

    v, w, refrac = state.v, state.w, state.refrac
    spk, vs = [], []
    for t in range(T):
        v, w, refrac, out = adex.membrane_step(
            v, w, refrac, drive[t], params, dt, adex=use_adex,
            decays=decays)
        spk.append(out)
        if record_v:
            vs.append(v)
    cshape = torch.broadcast_shapes(ie_t.shape[1:], state.v.shape)
    spikes_t = (torch.stack(spk) if T else
                torch.zeros((0, *cshape), dtype=torch.float32,
                            device=ie_t.device))
    recs = (spikes_t,)
    if record_v:
        recs = (spikes_t, torch.stack(vs) if T else torch.zeros_like(
            spikes_t))
    new_state = adex.NeuronState(v=v, w=w, i_exc=i_exc, i_inh=i_inh,
                                 refrac=refrac)
    return new_state, rate_counters + spikes_t.sum(0), recs
