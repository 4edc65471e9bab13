"""Virtual instances: fixed-seed Monte-Carlo mismatch realisations.

``sample_instance(cfg, generator, prefix)`` returns the full mismatch
realisation for ``prefix``-many chips; the same generator state always
yields the same silicon. ``torch.Generator`` streams differ from
``jax.random``'s, so a test that compares with the reference draws the
instance there and moves it over with ``repro_torch.convert``.
"""
from __future__ import annotations

from typing import Dict, Tuple

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
