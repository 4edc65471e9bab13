"""Plain PyTorch version of the stp_scan kernel: the STP efficacy
trajectory of a window as a loop of ``stp.efficacy`` and ``stp.update``
steps, the port's form of the reference's ``lax.scan``
(``repro/core/anncore.py:333-341``)."""
import torch

from repro_torch.core import stp


def stp_scan_ref(r0, spikes_t, scale, *, u: float, recovery: float):
    """r0 [*prefix, R]; spikes_t [T, *prefix, R]; scale [*prefix | 1, R].
    Returns (eff_t [T, *prefix, R], r_T [*prefix, R])."""
    s = stp.STPState(r=r0)
    eff = []
    for t in range(spikes_t.shape[0]):
        sp = spikes_t[t]
        eff.append(stp.efficacy(s, sp, u=u, scale=scale))
        s = stp.update(s, sp, u=u, recovery=recovery)
    if not eff:
        return spikes_t.new_empty((0, *r0.shape)), r0
    return torch.stack(eff), s.r
