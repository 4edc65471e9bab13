"""Virtual instances (fixed-seed Monte-Carlo mismatch realisations) and
the first-divergence locator of co-simulation traces.

``sample_instance(cfg, generator, prefix)`` returns the full mismatch
realisation for ``prefix``-many chips; the same generator state always
yields the same silicon. ``torch.Generator`` streams differ from
``jax.random``'s, so a test that compares with the reference draws the
instance there and moves it over with ``repro_torch.convert``.

``first_divergence`` / ``PHASE_OF_KIND`` / ``Divergence`` are numpy, a
copy of the reference's (``repro/verif/mismatch.py:83-175``): they
localize where two playback traces (``repro_torch.verif.playback``)
split.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.bss2 import BSS2Config
from repro_torch.core import capmem

# per-parameter mismatch kind: (sigma attribute, additive?)
_NEURON_SIGMA = {
    "g_leak": ("sigma_g_leak", False),
    "tau_syn_exc": ("sigma_tau_syn", False),
    "tau_syn_inh": ("sigma_tau_syn", False),
    "v_thres": ("sigma_v_thres", True),
}


def sample_instance(cfg: BSS2Config, generator: torch.Generator,
                    prefix: Tuple[int, ...] = (), device=None) -> Dict:
    """Mismatch realisation for a (batch of) virtual chip instance(s).

    Draws on the generator's device (a CPU generator keeps the stream
    independent of the card) and moves the result to ``device``."""
    device = resolve_device(device)
    mm = cfg.mismatch
    r, c = cfg.n_rows, cfg.n_cols
    gdev = generator.device

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=gdev)

    nom = capmem.nominal(cfg, device=gdev)
    neuron_params = {}
    for name in capmem.NEURON_PARAMS:
        v = nom[name].expand(*prefix, c)
        n = normal(*prefix, c)
        if name in _NEURON_SIGMA:
            attr, additive = _NEURON_SIGMA[name]
            sig = getattr(mm, attr)
            v = v + sig * n if additive else v * (1.0 + sig * n)
        else:
            v = v * (1.0 + mm.sigma_capmem * n)
        neuron_params[name] = v.to(device)
    return dict(
        neuron_params=neuron_params,
        weight_gain=(1.0 + mm.sigma_weight_gain * normal(*prefix, c)
                     ).to(device),
        stp_offset=(mm.sigma_stp_offset * normal(*prefix, r)).to(device),
        stp_calib=torch.full((*prefix, r), 2 ** (cfg.calib_bits - 1),
                             dtype=torch.int32, device=device),
        cadc_offset=(mm.sigma_cadc_offset * normal(*prefix, c)).to(device),
        cadc_gain=(1.0 + mm.sigma_cadc_gain * normal(*prefix, c)
                   ).to(device),
    )


def ideal_instance(cfg: BSS2Config, prefix: Tuple[int, ...] = (),
                   device=None) -> Dict:
    """Mismatch-free instance (the 'schematic' simulation)."""
    device = resolve_device(device)
    r, c = cfg.n_rows, cfg.n_cols
    f32 = dict(dtype=torch.float32, device=device)
    return dict(
        neuron_params={k: v.expand(*prefix, c).contiguous()
                       for k, v in capmem.nominal(cfg, device).items()},
        weight_gain=torch.ones((*prefix, c), **f32),
        stp_offset=torch.zeros((*prefix, r), **f32),
        stp_calib=torch.full((*prefix, r), 2 ** (cfg.calib_bits - 1),
                             dtype=torch.int32, device=device),
        cadc_offset=torch.zeros((*prefix, c), **f32),
        cadc_gain=torch.ones((*prefix, c), **f32),
    )


# ---------------------------------------------------------------------------
# First-divergence locator for co-simulation traces
# ---------------------------------------------------------------------------

# which emulation phase produced a given trace-record kind — the coarse
# "where in the machine" attribution of a divergence
PHASE_OF_KIND = {
    "SPIKES": "neuron-scan",
    "V": "neuron-scan",
    "RATES": "neuron-scan",
    "CORR": "corr",
    "WEIGHTS": "ppu",
    "PPU_W": "ppu-vm",
}


@dataclass
class Divergence:
    """Where two experiment traces first split.

    ``record`` is the index into the trace list; ``kind``/``t`` the
    record header; ``phase`` the emulation phase that produced the
    record (``PHASE_OF_KIND``). For array-value divergences ``where`` is
    the index of the first differing element, ``step`` its absolute
    timestep when the leading axis is time (SPIKES/V records: the
    record's end time minus the window length plus the row index), and
    ``a``/``b`` the two values there. Header/shape/length mismatches set
    ``structural=True`` and leave the element fields at None.
    """
    record: int
    kind: str
    t: int
    phase: str = "?"
    step: Optional[int] = None
    where: Optional[Tuple[int, ...]] = None
    a: Optional[float] = None
    b: Optional[float] = None
    n_mismatch: int = 0
    max_abs: float = 0.0
    structural: bool = False
    detail: str = ""

    def describe(self) -> str:
        if self.structural:
            return (f"trace diverges structurally at record {self.record} "
                    f"({self.kind}@{self.t}): {self.detail}")
        at_step = "" if self.step is None else f" step {self.step},"
        return (f"first divergence at record {self.record} "
                f"({self.kind}@{self.t}, phase {self.phase}):{at_step} "
                f"index {self.where} — {self.a:g} vs {self.b:g} "
                f"({self.n_mismatch} element(s) differ, "
                f"max|diff|={self.max_abs:.3e})")


def first_divergence(trace_a, trace_b, atol: float = 1e-3,
                     rtol: float = 1e-4) -> Optional[Divergence]:
    """Locate the FIRST point two playback traces split (None == match).

    Traces are lists of ``(t, kind, array)`` records as produced by
    ``repro_torch.verif.playback`` backends. Records are compared in order;
    the first mismatching one is localized down to the first differing
    element (first in C order: earliest timestep for time-leading
    records). Tolerances match ``compare_traces``.
    """
    for i, ((ta, ka, va), (tb, kb, vb)) in enumerate(zip(trace_a, trace_b)):
        if ta != tb or ka != kb:
            return Divergence(record=i, kind=str(ka), t=int(ta),
                              structural=True,
                              detail=f"header ({ta},{ka}) != ({tb},{kb})")
        va = np.asarray(va, np.float64)
        vb = np.asarray(vb, np.float64)
        if va.shape != vb.shape:
            return Divergence(record=i, kind=str(ka), t=int(ta),
                              phase=PHASE_OF_KIND.get(ka, "?"),
                              structural=True,
                              detail=f"shape {va.shape} != {vb.shape}")
        bad = ~np.isclose(va, vb, atol=atol, rtol=rtol)
        if bad.any():
            idx = tuple(int(j) for j in np.argwhere(bad)[0])
            step = None
            if ka in ("SPIKES", "V") and va.ndim >= 1:
                # record timestamp is the END of the integrated window
                step = int(ta) - va.shape[0] + idx[0]
            return Divergence(
                record=i, kind=str(ka), t=int(ta),
                phase=PHASE_OF_KIND.get(ka, "?"), step=step, where=idx,
                a=float(va[idx]), b=float(vb[idx]),
                n_mismatch=int(bad.sum()),
                max_abs=float(np.max(np.abs(va - vb))))
    if len(trace_a) != len(trace_b):
        n = min(len(trace_a), len(trace_b))
        longer = trace_a if len(trace_a) > len(trace_b) else trace_b
        t, k = longer[n][0], longer[n][1]
        return Divergence(record=n, kind=str(k), t=int(t), structural=True,
                          detail=f"trace length {len(trace_a)} != "
                                 f"{len(trace_b)}")
    return None
