"""Plain PyTorch reference of the paper's §5 closed loop with its R-STDP
rule as the chip computes it: the vector part a program on the PPU's
SIMD unit, in saturating Q8.8 fixed point.

The emulation (STP drivers, the 6-bit synapse array, AdEx neurons,
correlation sensors, the CADC read, the reward and Eq. 2's mean reward)
is ``bss2_fleet``'s. The rule is the §5 Dale-signed rule of the
configuration ``rule`` names, ``signed_dw_program``, written out here one
instruction after the other from the PPU-VM's stated semantics
(Q8.8 registers in int32 lanes; ADD, SUB, MULF and SHL saturate to the
int16 range; MULF rounds by adding half of its shift's unit before an
arithmetic right shift; VSPLAT's immediate is the constant times 256,
rounded half to even and saturated; LDCAUSAL and LDACAUSAL load the 8-bit
CADC codes as they are, code / 256 in Q8.8; LDRATE loads the rate counter
rounded half to even, shifted by 8 and saturated; LDMOD loads a
per-column modulator slot the scalar core deposited, rounded to Q8.8 as
VSPLAT's immediate is, in float32). Register 0 is the program's readout,
the per-synapse dw in Q8.8; the scalar core divides it by 256, adds it
and the xi walk to the signed float weights, clamps them to +-45 and
rewrites both Dale rows with the 6-bit store.

Departures from the program as the system runs it, none of which changes
a bit of its readout: the program here is evaluated on the excitatory
rows only (its readout on the inhibitory rows is never read); the
registers it writes but never reads back are not kept; the products are
taken in int64 (both operands lie in the int16 range, so no int32 product
wraps either). The constants are worked out from the configuration here,
by the formulas the program's assembler states: the eligibility gain is
``eta`` times 256 / ``cadc_max`` (the CADC codes load as fractions of 256,
the rule divides them by ``cadc_max``), then ``eta_homeo``,
``fire_thresh`` and 1.0.

It imports neither the port nor the JAX package. ``precision`` is
``bss2_fleet``'s: the product's arithmetic, the controls of the
comparison.
"""
from __future__ import annotations

import torch

from reference.bss2_fleet import (Fleet, corr_window, digitize,
                                  neuron_window, stp_window, weight_rows)

FRAC = 8
ONE = 1 << FRAC
I16MIN, I16MAX = -(1 << 15), (1 << 15) - 1


def sat16(x):
    """The saturating result of ADD, SUB, MULF and SHL."""
    return torch.clamp(x, I16MIN, I16MAX)


def splat(value: float) -> int:
    """VSPLAT's Q8.8 immediate of a constant: value * 256 rounded half to
    even (on the host, in double precision), saturated."""
    return int(min(max(round(float(value) * ONE), I16MIN), I16MAX))


def to_q88(x):
    """A modulator slot as the scalar core deposits it: float32 x * 256,
    rounded half to even, saturated, as int64 lanes."""
    return sat16(torch.round(x.to(torch.float32) * ONE)).to(torch.int64)


def mulf(a, b, shift: int = FRAC):
    """Fracsat multiply: (a b + 2^(shift-1)) >> shift, saturated."""
    return sat16((a * b + ((1 << shift) >> 1)) >> shift)


def signed_dw(qc, qa, rates, reward, mean_reward, exp: dict, cadc_max: int):
    """The Q8.8 dw of the excitatory rows [..., I, C] (int64), as
    ``signed_dw_program`` computes it, word by word (the register each
    word writes in the comment):

        dw = eta * (R - <R>) * (qc - qa) / cadc_max
           + eta_homeo * (1 - R) * (1 - 2 fired)

    ``qc``/``qa`` the CADC codes of those rows, ``rates`` [..., C] the
    rate counters, ``reward`` and ``mean_reward`` [..., C] (modulator
    slots 1 and 0: R and R - <R>)."""
    mod0 = to_q88(reward - mean_reward).unsqueeze(-2)     # slot 0: R - <R>
    mod1 = to_q88(reward).unsqueeze(-2)                   # slot 1: R
    e = sat16(qc.to(torch.int64) - qa.to(torch.int64))    # e: ldcausal,
    #                                                       t: ldacausal, sub
    k = splat(eta_gain(exp["eta"], cadc_max))             # k: vsplat
    m = mulf(k, mod0)                                     # m: ldmod 0, mulf
    e = mulf(m, e)                                        # e: mulf
    rate = sat16(torch.round(rates).to(torch.int64) << FRAC)   # m: ldrate
    fired = torch.where(rate >= splat(exp["fire_thresh"]), ONE, 0
                        ).unsqueeze(-2)                   # t: vsplat, cmpge
    one = splat(1.0)                                      # k: vsplat
    t = sat16(one - sat16(fired << 1))                    # m: shl; t: sub
    k = sat16(one - mod1)                                 # m: ldmod 1; sub
    t = mulf(k, t)                                        # t: mulf
    t = mulf(splat(exp["eta_homeo"]), t)                  # k: vsplat; mulf
    return sat16(e + t)                                   # e: add -> r0


def eta_gain(eta: float, cadc_max: int) -> float:
    """The eligibility term's constant: ``eta`` with the rule's division
    by ``cadc_max`` folded against the codes' load as fractions of 256."""
    return eta * (float(1 << 8) / float(cadc_max))


class FleetPPU(Fleet):
    """``bss2_fleet.Fleet`` with the rule's vector part in Q8.8 as the PPU
    program computes it. A trial's metrics add ``dw_q88``, the readout
    of the excitatory rows."""

    def trial(self, st: dict, stim, events, xi):
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
        fired = (rates >= exp["fire_thresh"]).to(torch.float32)
        own = torch.where(stim == 1, self.even,
                          torch.where(stim == 2, 1.0 - self.even, 0.0))
        reward = torch.where(own > 0, fired, 1.0 - fired)
        # the PPU: CADC read of both sensors' excitatory rows, the program
        cadc_max = 2 ** chip["cadc_bits"] - 1
        off = inst["cadc_offset"].unsqueeze(-2)
        gn = inst["cadc_gain"].unsqueeze(-2)
        qc = digitize(ac[..., 0::2, :], off, gn, chip["cadc_bits"], 8.0)
        qa = digitize(aa[..., 0::2, :], off, gn, chip["cadc_bits"], 8.0)
        elig = (qc - qa).to(torch.float32) / 255.0
        mr = st["mean_reward"]
        dw_q = signed_dw(qc, qa, rates, reward, mr, exp, cadc_max)
        del qc, qa
        # the scalar core: dw applied to the signed weights, the xi walk,
        # the clamp, Eq. 2, the Dale rows' 6-bit store
        dw = dw_q.to(torch.float32) / ONE
        w_signed = torch.clamp(st["w_signed"] + dw + xi, -45.0, 45.0)
        mean_r = mr + exp["gamma"] * (reward - mr)
        new = dict(neuron, r=r, trace_pre=tp, trace_post=tq,
                   a_causal=torch.zeros_like(ac),
                   a_acausal=torch.zeros_like(aa),
                   weights=weight_rows(w_signed),
                   rates=torch.zeros_like(rates), w_signed=w_signed,
                   mean_reward=mean_r)
        return new, dict(reward=reward, mean_reward=mean_r, rates=rates,
                         elig=elig, w=w_signed, closest=gaps.amin(0),
                         dw_q88=dw_q)
