"""Analog correlation sensors in each synapse (paper §2.1).

Each synapse accumulates causal (pre-before-post) and anti-causal traces
on storage capacitors, later digitized by the CADC for hybrid plasticity.
Exponentially decaying pre/post spike traces; a post spike adds the
row-wise pre-trace to the causal accumulator (outer product), a pre spike
adds the column-wise post-trace to the anti-causal accumulator. The window
form is the ``repro_torch.kernels.corr`` kernel.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class CorrelationState(NamedTuple):
    trace_pre: torch.Tensor    # [..., R] presynaptic trace
    trace_post: torch.Tensor   # [..., C] postsynaptic trace
    a_causal: torch.Tensor     # [..., R, C] on-capacitor accumulation
    a_acausal: torch.Tensor    # [..., R, C]


def init_state(shape_prefix, rows, cols, device) -> CorrelationState:
    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return CorrelationState(
        trace_pre=z(*shape_prefix, rows), trace_post=z(*shape_prefix, cols),
        a_causal=z(*shape_prefix, rows, cols),
        a_acausal=z(*shape_prefix, rows, cols))


def _decay(dt: float, tau: float) -> float:
    """``exp(-dt/tau)`` as the reference's per-step update computes it
    (float32 exp of a float32 argument), evaluated on the host."""
    return float(torch.exp(torch.tensor(-dt / tau, dtype=torch.float32)))


def update(state: CorrelationState, pre_spikes, post_spikes, *,
           tau_pre: float, tau_post: float, dt: float, eta: float = 1.0,
           sat: float = 1023.0) -> CorrelationState:
    """One dt step. pre_spikes: [..., R]; post_spikes: [..., C]."""
    tp = state.trace_pre * _decay(dt, tau_pre) + pre_spikes
    tq = state.trace_post * _decay(dt, tau_post) + post_spikes
    # causal: post spike samples the pre trace (outer product)
    a_c = state.a_causal + eta * tp.unsqueeze(-1) * post_spikes.unsqueeze(-2)
    # anti-causal: pre spike samples the post trace
    a_a = state.a_acausal + eta * pre_spikes.unsqueeze(-1) * tq.unsqueeze(-2)
    # storage capacitors saturate
    return CorrelationState(trace_pre=tp, trace_post=tq,
                            a_causal=torch.clamp_max(a_c, sat),
                            a_acausal=torch.clamp_max(a_a, sat))


def window(state: CorrelationState, pre_t, post_t, *, tau_pre: float,
           tau_post: float, dt: float, eta: float = 1.0,
           sat: float = 1023.0) -> CorrelationState:
    """Apply a whole [T, ...] spike window to the sensors in one shot.

    The sensors never feed back into the neuron dynamics within a trial,
    so the per-dt update is hoisted out of the emulation and replayed here
    once. Where the corr kernel applies (``tau_pre == tau_post`` and
    ``eta == 1``, the machine's own setting) the window goes through its
    wrapper: the kernel on a CUDA device, its per-step plain version on
    the CPU, so both devices give the same bits. Other parameters take the
    reference's CPU form (``_window_contracted``) on the CPU and raise on
    a CUDA device, where no kernel covers them.

    pre_t: [T, ..., R]; post_t: [T, ..., C].
    """
    if tau_pre == tau_post and eta == 1.0:
        from repro_torch.kernels.corr import ops as corr_ops
        lam = math.exp(-dt / tau_pre)
        ac, aa, tp, tq = corr_ops.correlation_window(
            pre_t.to(torch.float32), post_t.to(torch.float32),
            state.trace_pre, state.trace_post, state.a_causal,
            state.a_acausal, lam=lam, sat=sat)
        return CorrelationState(trace_pre=tp, trace_post=tq,
                                a_causal=ac, a_acausal=aa)
    if state.a_causal.device.type != "cpu":
        raise NotImplementedError(
            "the corr kernel supports tau_pre == tau_post and eta == 1.0 "
            "only")
    return _window_contracted(state, pre_t, post_t, tau_pre=tau_pre,
                              tau_post=tau_post, dt=dt, eta=eta, sat=sat)


def _window_contracted(state, pre_t, post_t, *, tau_pre, tau_post, dt, eta,
                       sat):
    """The reference's CPU form (``repro/core/correlation.py:104-123``):
    trace scans, one contraction over the window, then the clamp. With
    non-negative spikes and ``eta >= 0`` every increment is non-negative,
    so the running accumulator is monotone and clamping after the window
    equals clamping per step; what differs from the per-step form is float
    summation order (~1 ulp)."""
    if eta < 0.0:       # monotonicity argument breaks: exact per-step scan
        for t in range(pre_t.shape[0]):
            state = update(state, pre_t[t], post_t[t], tau_pre=tau_pre,
                           tau_post=tau_post, dt=dt, eta=eta, sat=sat)
        return state

    def trace(t0, s_t, tau):
        lam_t = _decay(dt, tau)
        out = []
        for t in range(s_t.shape[0]):
            t0 = t0 * lam_t + s_t[t]
            out.append(t0)
        return t0, torch.stack(out)

    tp_f, tp_t = trace(state.trace_pre, pre_t, tau_pre)
    tq_f, tq_t = trace(state.trace_post, post_t, tau_post)
    a_c = state.a_causal + eta * torch.einsum("t...r,t...c->...rc",
                                              tp_t, post_t)
    a_a = state.a_acausal + eta * torch.einsum("t...r,t...c->...rc",
                                               pre_t, tq_t)
    return CorrelationState(trace_pre=tp_f, trace_post=tq_f,
                            a_causal=torch.clamp_max(a_c, sat),
                            a_acausal=torch.clamp_max(a_a, sat))
