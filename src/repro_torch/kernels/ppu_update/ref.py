"""Plain PyTorch version of the ppu_update kernel (the twin of
``repro/kernels/ppu_update/ref.py``): CADC digitization of both
accumulators, eligibility, the R-STDP step and the saturating 6-bit
store, in the kernel's operation order.

The eligibility ``(qc - qa) / cadc_max`` is computed as a multiply by the
float32 reciprocal ``1 / cadc_max``, on every device and in the kernel:
that is what PyTorch's CUDA division by a Python float does and what XLA
makes of the reference's jitted division by a constant, so the quotient
is tier 1 against the jitted reference (the CPU's true division would
differ from it by an ulp for some codes)."""
import numpy as np
import torch


def reciprocal(cadc_max: int) -> float:
    """float32 ``1 / cadc_max`` (a Python float that holds it exactly)."""
    return float(np.float32(1.0) / np.float32(cadc_max))


def rstdp_update_ref(weights, a_causal, a_acausal, cadc_offset, cadc_gain,
                     mod, xi, *, eta: float, cadc_scale: float = 8.0,
                     wmax: int = 63, cadc_max: int = 255, cadc_map=None):
    """weights [..., R, C] int8; a_causal/a_acausal/xi [..., R, C] float32;
    cadc_offset/cadc_gain/mod [..., C] float32; ``cadc_map``: ``None`` or
    the CADC faults as float32 ``(a, lo, hi)`` [..., C]
    (``faults.inject.cadc_map``), each code then ``min(max(q + a, lo),
    hi)``. Returns (new weights int8, eligibility float32)."""
    off = cadc_offset.unsqueeze(-2)
    g = cadc_gain.unsqueeze(-2) * cadc_scale

    def digitize(a):
        q = torch.clamp(torch.round(a * g + off), 0.0, float(cadc_max))
        if cadc_map is not None:
            fa, lo, hi = (x.unsqueeze(-2) for x in cadc_map)
            q = torch.minimum(torch.maximum(q + fa, lo), hi)
        return q

    elig = (digitize(a_causal) - digitize(a_acausal)) * reciprocal(cadc_max)
    w_new = weights.to(torch.float32) + (eta * mod).unsqueeze(-2) * elig + xi
    w_q = torch.clamp(torch.round(w_new), 0, wmax).to(torch.int8)
    return w_q, elig
