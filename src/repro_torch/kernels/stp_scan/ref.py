"""Plain PyTorch version of the stp_scan kernel: the STP efficacy
trajectory of a window as a loop of ``stp.efficacy`` and ``stp.update``
steps, the port's form of the reference's ``lax.scan``
(``repro/core/anncore.py:333-341``); in its census form followed by the
census of each Dale half of the efficacies (``census_ref`` on rows
``0::2`` and ``1::2``), the reference's ``lax.cond`` predicate
(``repro/core/synapse.py:250-251``) of the two synaptic windows."""
import torch

from repro_torch.core import stp
from repro_torch.kernels.census.ref import census_ref


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


def stp_scan_census_ref(r0, spikes_t, scale, *, u: float, recovery: float,
                        caps):
    """``stp_scan_ref`` and the census of each Dale half: ``caps`` is
    ``((max_events, k_cap) of rows 0::2, (max_events, k_cap) of rows
    1::2)``. Returns (eff_t, r_T, census_exc, census_inh), each census an
    int32 [3] (fits, n_events, k_max)."""
    eff, r_T = stp_scan_ref(r0, spikes_t, scale, u=u, recovery=recovery)
    return (eff, r_T, *(census_ref(eff[..., h::2], me, kc)
                        for h, (me, kc) in enumerate(caps)))
