"""Learning rules written as PPU-VM programs (paper §2.2, §5).

Each function returns the dense int32 instruction words that implement the
vector (row-parallel) part of a rule from ``repro_torch.core.rules``; the scalar
part — Eq. 2's running mean, PRNG advance — stays on the "scalar core"
(the PyTorch wrapper, ``VectorUnit.apply_rstdp_program`` or the
playback ``PPU_RUN`` glue), exactly like the silicon splits work between
the Power core and the vector unit.

Scaling notes: CADC codes load as fractions code/2^8 while the float
oracles divide by ``cadc_max`` = 2^8 - 1, so every per-code gain constant
is folded with the ratio 2^8/cadc_max at assembly time; constants are
Q8.8, so programs match their float oracles to ~2^-9 per operation —
within one 6-bit weight LSB after the saturating store (the acceptance
bound; see tests/test_ppuvm.py). A copy of ``repro/ppuvm/programs.py``:
the words are held equal to the original's by tests/test_torch_ppuvm.py.
"""
from __future__ import annotations

import numpy as np

from repro_torch.ppuvm import isa
from repro_torch.ppuvm.asm import Asm


def _code_scale(cadc_max: int) -> float:
    """Fold the oracle's /cadc_max against the VM's /2^FRAC fractional
    CADC load."""
    return float(1 << 8) / float(cadc_max)


def rstdp_program(*, eta: float = 0.5, cadc_max: int = 255) -> np.ndarray:
    """R-STDP Eq. 3 vector part (``rules.rstdp`` / ``apply_rstdp`` ref):

        w <- sat6(w + eta * (R - <R>) * (qc - qa)/cadc_max + xi)

    Modulator slot 0 carries R - <R>; the noise plane carries xi.
    """
    a = Asm()
    e, t, k, m = a.reg("e"), a.reg("t"), a.reg("k"), a.reg("m")
    a.ldcausal(e)
    a.ldacausal(t)
    a.sub(e, e, t)                        # e = (qc - qa) / 2^8
    a.splat(k, eta * _code_scale(cadc_max))
    a.ldmod(m, 0)                         # m = R - <R>
    a.mulf(m, k, m)                       # m = eta' * mod
    a.mulf(e, m, e)                       # e = eta' * mod * elig
    a.ldw(t)
    a.add(t, t, e)
    a.ldnoise(m)                          # xi random walk
    a.add(t, t, m)
    a.stw(t)                              # saturating 6-bit write-back
    return a.build()


def stdp_program(*, eta_plus: float = 0.1, eta_minus: float = 0.12,
                 cadc_max: int = 255) -> np.ndarray:
    """Plain additive STDP (``rules.stdp``):

        w <- sat6(w + (eta_plus * qc - eta_minus * qa) / cadc_max)
    """
    a = Asm()
    c, q, k, w = a.reg("c"), a.reg("q"), a.reg("k"), a.reg("w")
    a.ldcausal(c)
    a.splat(k, eta_plus * _code_scale(cadc_max))
    a.mulf(c, k, c)
    a.ldacausal(q)
    a.splat(k, eta_minus * _code_scale(cadc_max))
    a.mulf(q, k, q)
    a.sub(c, c, q)
    a.ldw(w)
    a.add(w, w, c)
    a.stw(w)
    return a.build()


def homeostasis_program(*, target_rate: float, eta: float = 0.2
                        ) -> np.ndarray:
    """Rate homeostasis (``rules.homeostasis``):

        w <- sat6(w + eta * (target_rate - rates))
    """
    a = Asm()
    r, k, w = a.reg("r"), a.reg("k"), a.reg("w")
    a.ldrate(r)
    a.splat(k, target_rate)
    a.sub(r, k, r)                        # target - rates
    a.splat(k, eta)
    a.mulf(r, k, r)
    a.ldw(w)
    a.add(w, w, r)
    a.stw(w)
    return a.build()


def signed_dw_program(*, eta: float, eta_homeo: float, fire_thresh: float,
                      cadc_max: int = 255) -> np.ndarray:
    """The §5 experiment's Dale-signed rule, vector part: per-row weight
    delta (no store — the scalar core applies it to the PPU-resident
    signed float state and rewrites both signed rows, see
    ``repro_torch.core.hybrid``). Register 0 holds the readout:

        dw = eta * mod * (qc - qa)/cadc_max
           + eta_homeo * (1 - R) * (1 - 2 * fired)

    Modulator slot 0 = R - <R>, slot 1 = R; ``fired`` = rates >= thresh.
    """
    a = Asm()
    e, t, k, m = a.reg("e"), a.reg("t"), a.reg("k"), a.reg("m")
    assert e == 0, "readout register is r0"
    a.ldcausal(e)
    a.ldacausal(t)
    a.sub(e, e, t)                        # (qc - qa) / 2^8
    a.splat(k, eta * _code_scale(cadc_max))
    a.ldmod(m, 0)                         # R - <R>
    a.mulf(m, k, m)
    a.mulf(e, m, e)                       # eligibility term
    a.ldrate(m)
    a.splat(t, fire_thresh)
    a.cmpge(t, m, t)                      # fired mask (ONE / 0)
    a.splat(k, 1.0)
    a.shl(m, t, 1)                        # 2 * fired
    a.sub(t, k, m)                        # 1 - 2*fired
    a.ldmod(m, 1)                         # R
    a.sub(k, k, m)                        # 1 - R
    a.mulf(t, k, t)
    a.splat(k, eta_homeo)
    a.mulf(t, k, t)                       # homeostatic escape term
    a.add(e, e, t)                        # r0 = dw
    return a.build()
