"""AdEx / LIF neuron dynamics (paper §2.1, Eqs. for V and w).

  C dV/dt = -g_L (V - E_L) + g_L Δ_T exp((V - V_T)/Δ_T) - w + I
  τ_w dw/dt = a (V - E_L) - w

Exponential Euler on the leak/adaptation terms, explicit on the (clipped)
exponential current; V > V_thres + spike latch -> reset + refractory hold.
Op trees follow ``repro/core/adex.py`` one for one. The CUDA kernel of
``repro_torch.kernels.neuron_scan`` repeats these same operations in the
same order (``csrc/neuron_scan.cu``), so its spikes match bit for bit.

All tensors broadcast over a leading instance/batch shape: states are
[..., N] for N neurons.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch


class NeuronState(NamedTuple):
    v: torch.Tensor           # membrane potential [mV]
    w: torch.Tensor           # adaptation current [pA]
    i_exc: torch.Tensor       # excitatory synaptic current state [pA]
    i_inh: torch.Tensor       # inhibitory synaptic current state [pA]
    refrac: torch.Tensor      # remaining refractory time [us]


def init_state(shape, params) -> NeuronState:
    dev = params["e_leak"].device

    def z():
        return torch.zeros(shape, dtype=torch.float32, device=dev)
    return NeuronState(
        v=params["e_leak"].expand(shape).to(torch.float32).clone(),
        w=z(), i_exc=z(), i_inh=z(), refrac=z())


def decay_factors(params: Dict, dt: float) -> Dict:
    """Time-invariant per-step decay terms (the formulas ``step`` would
    compute inline); precompute once and pass as ``decays``."""
    def neg_dt_over(tau):
        # a true division: ``float / tensor`` is ``reciprocal() * float``
        # in PyTorch, two roundings where the reference has one
        return torch.div(torch.tensor(-dt, dtype=tau.dtype,
                                      device=tau.device), tau)
    tau_m = params["c_mem"] / params["g_leak"]
    return dict(de=torch.exp(neg_dt_over(params["tau_syn_exc"])),
                di=torch.exp(neg_dt_over(params["tau_syn_inh"])),
                alpha=torch.exp(neg_dt_over(tau_m)),
                aw=torch.exp(neg_dt_over(params["tau_w"])))


def integrate_currents(i_exc, i_inh, i_syn_exc, i_syn_inh, decays: Dict):
    """One dt of the synaptic-current states: exponential kernels, pulses
    add instantaneously. Independent of the membrane state."""
    return (i_exc * decays["de"] + i_syn_exc,
            i_inh * decays["di"] + i_syn_inh)


def membrane_step(v, w, refrac, i_drive, params: Dict, dt: float,
                  adex: bool = True, decays: Dict = None):
    """The sequential membrane core of one dt step.

    ``i_drive`` is the integrated net synaptic current ``i_exc - i_inh``.
    Returns ``(v, w, refrac, spikes_f32)``.
    """
    g_l = params["g_leak"]
    i_total = i_drive - w

    # exponential escape current (clamped like the saturating circuit)
    if adex:
        arg = torch.clamp((v - params["v_thres"]) / params["delta_t"],
                          -20.0, 3.0)
        i_exp = g_l * params["delta_t"] * torch.exp(arg)
    else:
        i_exp = 0.0

    v_inf = params["e_leak"] + (i_total + i_exp) / g_l
    v_new = v_inf + (v - v_inf) * decays["alpha"]

    # adaptation (exponential Euler towards a(V - E_L))
    w_inf = params["a"] * (v - params["e_leak"])
    w_new = w_inf + (w - w_inf) * decays["aw"]

    # refractory clamp
    in_refrac = refrac > 0.0
    v_new = torch.where(in_refrac, params["e_reset"], v_new)
    w_new = torch.where(in_refrac, w, w_new)

    # spike detection: threshold crossing ends the integration step
    spike_v = params["v_thres"] + (2.0 * params["delta_t"] if adex else 0.0)
    spikes = (v_new > spike_v) & ~in_refrac
    v_new = torch.where(spikes, params["e_reset"], v_new)
    w_new = torch.where(spikes, w_new + params["b"], w_new)
    refrac = torch.where(spikes, params["tau_refrac"],
                         torch.clamp_min(refrac - dt, 0.0))
    return v_new, w_new, refrac, spikes.to(torch.float32)


def step(state: NeuronState, i_syn_exc, i_syn_inh, params: Dict, dt: float,
         adex: bool = True, decays: Dict = None):
    """One dt step. Returns (new_state, spikes[..., N] float32 in {0,1})."""
    if decays is None:
        decays = decay_factors(params, dt)
    i_exc, i_inh = integrate_currents(state.i_exc, state.i_inh,
                                      i_syn_exc, i_syn_inh, decays)
    v, w, refrac, spikes = membrane_step(
        state.v, state.w, state.refrac, i_exc - i_inh, params, dt,
        adex=adex, decays=decays)
    return NeuronState(v=v, w=w, i_exc=i_exc, i_inh=i_inh,
                       refrac=refrac), spikes
