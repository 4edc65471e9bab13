"""Capacitive memory (analog parameter storage) model.

Each neuron has its own copy of every analog parameter. Values are stored
as nominal + per-instance deviation; the deviation comes from the mismatch
model in ``repro_torch.verif.mismatch`` (virtual instances).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import resolve_device
from repro_torch.configs.bss2 import BSS2Config

# parameters stored per neuron column (the subset that drives the
# behavioural equations)
NEURON_PARAMS = (
    "g_leak", "e_leak", "v_thres", "e_reset", "v_exp", "delta_t",
    "tau_w", "a", "b", "tau_refrac", "tau_syn_exc", "tau_syn_inh", "c_mem",
)


def nominal(cfg: BSS2Config, device=None) -> Dict[str, torch.Tensor]:
    """Nominal (datasheet) parameter set, broadcast per neuron."""
    device = resolve_device(device)
    p = cfg.neuron
    return {name: torch.full((cfg.n_cols,), getattr(p, name),
                             dtype=torch.float32, device=device)
            for name in NEURON_PARAMS}
