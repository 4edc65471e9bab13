"""Plain PyTorch reference of the paper's §5 closed loop on a fleet of
BrainScaleS-2 chips: R-STDP pattern discrimination, one trial after the
other.

It follows the published model (Grübl et al. 2020, §2.1-2.2, §5) step by
step with no kernel, no graph and no batching over time: the STP drivers
(Tsodyks-Markram), the 6-bit synapse array read as one product per Dale
half, the AdEx neurons by exponential Euler, the correlation sensors and
their CADC read, the Dale-signed R-STDP rule with its 6-bit write-back,
the reward and Eq. 2's mean reward. Each operation is written in the order
the machine model defines it, so that where the system under test agrees
with it, it agrees to the last bit except for the synaptic sums, whose
order of summation differs.

It imports neither the port nor the JAX package. All it is given is the
configuration (the JSON file beside the configuration module), the
instance and the draws the benchmark made, and the state a call starts
from. ``precision`` selects the product's arithmetic: "fp32" (float32,
TF32 off: the configuration's), "tf32" or "bf16" (its operands rounded to
TF32's 10 or bfloat16's 7 mantissa bits, float32 accumulation): the
controls of the comparison.
"""
from __future__ import annotations

import math

import torch

WMAX = 63
CALIB_BITS = 4
CALIB_STEP = 0.1
CORR_SAT = 1023.0
# a membrane "at the threshold": where two runs whose synaptic sums differ
# in their last bits may spike differently
NEAR_ATOL = NEAR_RTOL = 1e-4


def at_threshold(closest, p):
    """Where a membrane that ended ``closest`` from the spike threshold of
    the neurons ``p`` lay at it."""
    spike_v = p["v_thres"] + 2.0 * p["delta_t"]
    return closest <= NEAR_ATOL + NEAR_RTOL * spike_v.abs()


def round_mantissa(x, bits: int):
    """float32 ``x`` rounded to ``bits`` mantissa bits, to nearest, ties
    to even (finite values)."""
    drop = 23 - bits
    i = x.contiguous().view(torch.int32)
    lsb = (i >> drop) & 1
    i = (i + ((1 << (drop - 1)) - 1) + lsb) & ~((1 << drop) - 1)
    return i.view(torch.float32)


def operand(x, precision: str):
    """A product's operand in ``precision``."""
    if precision == "fp32":
        return x
    if precision == "tf32":
        return round_mantissa(x, 10)
    if precision == "bf16":
        return round_mantissa(x, 7)
    raise ValueError(f"unknown precision {precision!r}")


def decays(params, dt: float):
    """The per-neuron decay factors of one step, exp(-dt / tau) in float32
    on the host (``params`` on any device), returned on the params'
    device."""
    dev = params["tau_syn_exc"].device

    def f(tau):
        tau = tau.detach().cpu()
        return torch.exp(torch.div(torch.tensor(-dt, dtype=tau.dtype),
                                   tau)).to(dev)
    tau_m = params["c_mem"].cpu() / params["g_leak"].cpu()
    return dict(de=f(params["tau_syn_exc"]), di=f(params["tau_syn_inh"]),
                alpha=f(tau_m), aw=f(params["tau_w"]))


def stp_scale(inst):
    """The calibrated efficacy scale of each driver row."""
    trim = (inst["stp_calib"].to(torch.float32) - 2 ** (CALIB_BITS - 1)) \
        * CALIB_STEP
    return 1.0 + inst["stp_offset"] - trim


def stp_recovery(chip: dict) -> float:
    """1 - exp(-dt / tau_rec), in float32."""
    e = torch.exp(torch.tensor(-chip["dt"] / chip["stp_tau_rec"],
                               dtype=torch.float32))
    return float(1.0 - e)


def stp_window(r, spikes_t, scale, u: float, rec: float):
    """The efficacy of each event of a [T, ..., R] window, and the
    resources after it."""
    eff = []
    for t in range(spikes_t.shape[0]):
        sp = spikes_t[t]
        eff.append(torch.clamp(u * r * scale, 0.0, 1.5) * sp)
        r = r + (1.0 - r) * rec
        r = r - u * r * sp
        r = torch.clamp(r, 0.0, 1.0)
    return torch.stack(eff), r


def neuron_window(st, ie_t, ii_t, p, dk, dt: float):
    """AdEx neurons over a [T, ..., C] current window. Returns the spikes
    [T, ..., C], the state after the window and, for every step, how far
    the membrane ended from the spike threshold ([T, ..., C], infinite
    while refractory): where the system under test and the reference
    part, the membrane has to have been at the threshold."""
    i_exc, i_inh = st["i_exc"], st["i_inh"]
    v, w, refrac = st["v"], st["w_adapt"], st["refrac"]
    g_l, spike_v = p["g_leak"], p["v_thres"] + 2.0 * p["delta_t"]
    spikes, gaps = [], []
    for t in range(ie_t.shape[0]):
        i_exc = i_exc * dk["de"] + ie_t[t]
        i_inh = i_inh * dk["di"] + ii_t[t]
        i_total = (i_exc - i_inh) - w
        arg = torch.clamp((v - p["v_thres"]) / p["delta_t"], -20.0, 3.0)
        i_exp = g_l * p["delta_t"] * torch.exp(arg)
        v_inf = p["e_leak"] + (i_total + i_exp) / g_l
        v_new = v_inf + (v - v_inf) * dk["alpha"]
        w_inf = p["a"] * (v - p["e_leak"])
        w_new = w_inf + (w - w_inf) * dk["aw"]
        in_refrac = refrac > 0.0
        v_new = torch.where(in_refrac, p["e_reset"], v_new)
        w_new = torch.where(in_refrac, w, w_new)
        fired = (v_new > spike_v) & ~in_refrac
        gaps.append(torch.where(in_refrac, math.inf,
                                (v_new - spike_v).abs()))
        v = torch.where(fired, p["e_reset"], v_new)
        w = torch.where(fired, w_new + p["b"], w_new)
        refrac = torch.where(fired, p["tau_refrac"],
                             torch.clamp_min(refrac - dt, 0.0))
        spikes.append(fired.to(torch.float32))
    return torch.stack(spikes), dict(v=v, w_adapt=w, i_exc=i_exc,
                                     i_inh=i_inh, refrac=refrac), \
        torch.stack(gaps)


def corr_window(tp, tq, ac, aa, pre_t, post_t, lam: float):
    """The correlation sensors over a window: decaying pre and post
    traces; a post spike adds its column's pre traces to the causal
    accumulators, a pre event adds its row's post traces to the
    anti-causal ones; both saturate."""
    for t in range(pre_t.shape[0]):
        p, q = pre_t[t], post_t[t]
        tp = tp * lam + p
        tq = tq * lam + q
        ac = torch.clamp_max(ac + tp.unsqueeze(-1) * q.unsqueeze(-2),
                             CORR_SAT)
        aa = torch.clamp_max(aa + p.unsqueeze(-1) * tq.unsqueeze(-2),
                             CORR_SAT)
    return tp, tq, ac, aa


def digitize(x, offset, gain, bits: int, in_scale: float):
    """The CADC: 8-bit codes with per-column offset and gain."""
    code = x * (gain * in_scale) + offset
    return torch.clamp(torch.round(code), 0, 2 ** bits - 1).to(torch.int32)


def quantize(w):
    """The PPU's saturating 6-bit store."""
    return torch.clamp(torch.round(w), 0, WMAX).to(torch.int8)


def weight_rows(w_signed):
    """Signed input weights [..., I, C] -> driver rows [..., 2I, C]: row 2i
    excitatory (|w| where w > 0), row 2i + 1 inhibitory."""
    rows = torch.stack([torch.clamp(w_signed, min=0),
                        torch.clamp(-w_signed, min=0)], dim=-2)
    return quantize(rows.reshape(*w_signed.shape[:-2], -1,
                                 w_signed.shape[-1]))


class Fleet:
    """The §5 experiment on ``prefix``-many independent chips, given the
    configuration ``cfg`` (``chip`` and ``experiment`` groups) and the
    benchmark's instance."""

    def __init__(self, cfg: dict, inst: dict, precision: str = "fp32"):
        self.chip, self.exp = cfg["chip"], cfg["experiment"]
        self.inst, self.p = inst, inst["neuron_params"]
        self.precision = precision
        self.dk = decays(self.p, self.chip["dt"])
        self.scale = stp_scale(inst)
        self.rec = stp_recovery(self.chip)
        self.lam = math.exp(-self.chip["dt"] / self.chip["neuron"]
                            ["tau_syn_exc"])
        C, dev = self.exp["n_neurons"], inst["weight_gain"].device
        self.even = (torch.arange(C, device=dev) % 2 == 0).to(torch.float32)

    def init_state(self):
        """Membranes at rest, resources full, sensors and counters empty,
        every signed weight at ``w_init`` and written to the array."""
        p, exp = self.p, self.exp
        shape = p["e_leak"].shape
        R, I, C = 2 * exp["n_inputs"], exp["n_inputs"], exp["n_neurons"]
        prefix, dev = shape[:-1], p["e_leak"].device

        def z(*s):
            return torch.zeros(s, dtype=torch.float32, device=dev)
        w0 = exp["w_init"] * torch.ones((*prefix, I, C), device=dev)
        return dict(v=p["e_leak"].clone(), w_adapt=z(*shape),
                    i_exc=z(*shape), i_inh=z(*shape), refrac=z(*shape),
                    r=torch.ones((*prefix, R), device=dev),
                    trace_pre=z(*prefix, R), trace_post=z(*prefix, C),
                    a_causal=z(*prefix, R, C), a_acausal=z(*prefix, R, C),
                    weights=weight_rows(w0), rates=z(*shape), w_signed=w0,
                    mean_reward=z(*shape))

    def product(self, eff_t, weights):
        """The synaptic sums of one Dale half: [T, ..., R] efficacies times
        the [..., R, C] 6-bit weights."""
        a = operand(eff_t, self.precision)
        b = operand(weights.to(torch.float32), self.precision)
        return torch.einsum("t...r,...rc->t...c", a, b)

    def trial(self, st: dict, stim, events, xi):
        """One trial: emulate the window, reward, rule. ``stim`` a 0-d int
        tensor in {0: none, 1: A, 2: B}, ``events`` [T, ..., 2I] {0, 1},
        ``xi`` [..., I, C]. Returns the state after it and the
        trial's metrics (reward, mean reward, rates, eligibility, signed
        weights) and how close each column's membrane came to the spike
        threshold (``closest``)."""
        chip, exp, inst = self.chip, self.exp, self.inst
        eff_t, r = stp_window(st["r"], events, self.scale, chip["stp_u"],
                              self.rec)
        gain = inst["weight_gain"]
        w = st["weights"]
        ie = self.product(eff_t[..., 0::2], w[..., 0::2, :]) * gain * 60.0
        ii = self.product(eff_t[..., 1::2], w[..., 1::2, :]) * gain * 60.0
        del eff_t
        spikes, neuron, gaps = neuron_window(st, ie, ii, self.p, self.dk,
                                             chip["dt"])
        del ie, ii
        rates = st["rates"] + spikes.sum(0)
        tp, tq, ac, aa = corr_window(st["trace_pre"], st["trace_post"],
                                     st["a_causal"], st["a_acausal"],
                                     events, spikes, self.lam)
        # reward: a column fires (rate >= threshold) for its own stimulus
        # and stays silent for the others
        fired = (rates >= exp["fire_thresh"]).to(torch.float32)
        own = torch.where(stim == 1, self.even,
                          torch.where(stim == 2, 1.0 - self.even, 0.0))
        reward = torch.where(own > 0, fired, 1.0 - fired)
        # the PPU: CADC read of both sensors, the Dale-signed rule
        off = inst["cadc_offset"].unsqueeze(-2)
        gn = inst["cadc_gain"].unsqueeze(-2)
        qc = digitize(ac, off, gn, chip["cadc_bits"], 8.0)
        qa = digitize(aa, off, gn, chip["cadc_bits"], 8.0)
        elig = (qc[..., 0::2, :] - qa[..., 0::2, :]).to(torch.float32) / 255.0
        del qc, qa
        mr = st["mean_reward"]
        mod = (reward - mr).unsqueeze(-2)
        dw = exp["eta"] * mod * elig
        dw = dw + exp["eta_homeo"] * ((1.0 - reward)
                                      * (1.0 - 2.0 * fired)).unsqueeze(-2)
        w_signed = torch.clamp(st["w_signed"] + dw + xi, -45.0, 45.0)
        mean_r = mr + exp["gamma"] * (reward - mr)
        new = dict(neuron, r=r, trace_pre=tp, trace_post=tq,
                   a_causal=torch.zeros_like(ac),
                   a_acausal=torch.zeros_like(aa),
                   weights=weight_rows(w_signed),
                   rates=torch.zeros_like(rates), w_signed=w_signed,
                   mean_reward=mean_r)
        return new, dict(reward=reward, mean_reward=mean_r, rates=rates,
                         elig=elig, w=w_signed, closest=gaps.amin(0))

    def run(self, st: dict, stims, events, xi, each=None):
        """The trials of one call from ``st``, eagerly, one after the
        other: ``each(i, metrics)`` sees every trial's metrics. Returns the
        final state."""
        dev = events.device
        for i, s in enumerate(stims):
            stim = torch.full((), int(s), dtype=torch.int32, device=dev)
            st, m = self.trial(st, stim, events[i], xi[i])
            if each is not None:
                each(i, m)
        return st
