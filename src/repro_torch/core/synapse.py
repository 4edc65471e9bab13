"""Synapse array: 6-bit weights + 6-bit address matching (paper §2.1).

Each synapse stores a 6-bit weight and a 6-bit address; an event on a row
carries a source address and the synapse forwards current only when the
stored address matches. The hot operation — events x weights -> per-column
currents — is the masked product of ``repro_torch.kernels.synray``.

Only the dense path is ported so far. The event-sparse path of the
reference (``repro/core/events.py`` with the ``synray_sparse`` kernel) is
the next slice: ``sparse="always"``, and ``"auto"`` above the static work
floor, raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

WMAX = 63  # 6-bit


class SynapseArray(NamedTuple):
    weights: torch.Tensor    # [..., rows, cols] int8 in [0, 63]
    addresses: torch.Tensor  # [..., rows, cols] int8 in [0, 63]


def init_array(shape_prefix, rows, cols, device) -> SynapseArray:
    z = torch.zeros((*shape_prefix, rows, cols), dtype=torch.int8,
                    device=device)
    return SynapseArray(weights=z, addresses=z.clone())


def synaptic_current(weights, addresses, row_events, event_addr, gain):
    """Per-column synaptic current from one event step.

    weights/addresses: [..., R, C] int8; row_events: [..., R] float;
    event_addr: [..., R] int8; gain: scalar or [..., C]. Returns [..., C].
    """
    match = (addresses == event_addr.unsqueeze(-1)).to(torch.float32)
    w_eff = weights.to(torch.float32) * match
    i = torch.einsum("...rc,...r->...c", w_eff,
                     row_events.to(torch.float32))
    return i * gain


# Static work floor (T * R * C MACs) of the reference: below it
# sparse="auto" compiles to the pure dense program there.
SPARSE_MIN_DENSE_WORK = 2 * 1024 * 1024


def _dense_window(weights, addresses, row_events_t, event_addr_t, gain,
                  const_addr):
    """The dense whole-window path: the synray kernel on a CUDA device;
    on the CPU, with ``const_addr``, the once-resolved matmul of the
    reference's ``ref`` branch, else the kernel's plain version."""
    if weights.device.type == "cpu" and const_addr:
        match = (addresses == event_addr_t[0].unsqueeze(-1)
                 ).to(torch.float32)
        w_eff = weights.to(torch.float32) * match
        ev = row_events_t.to(torch.float32)
        if weights.ndim == 2:     # no instance prefix: plain matmul
            i = ev @ w_eff
        else:
            i = torch.einsum("t...r,...rc->t...c", ev, w_eff)
        return i * gain
    from repro_torch.kernels.synray import ops as synray_ops
    # on the card the masked kernel runs even with const_addr, as the
    # reference's main path does on its accelerator
    return synray_ops.synaptic_current(
        row_events_t.to(torch.float32), event_addr_t, weights,
        addresses) * gain


def synaptic_current_window(weights, addresses, row_events_t, event_addr_t,
                            gain, const_addr: bool = False,
                            sparse: str = "auto"):
    """Whole-window synaptic currents: [T, ..., R] events -> [T, ..., C].

    Weights and addresses are constant between PPU writes, so the per-step
    masked product collapses into one time-batched product (time is the
    kernel's batch axis). ``const_addr=True`` asserts each row's event
    address is the same at every step of the window; the CPU path then
    resolves the mask once into an effective weight matrix.

    ``sparse``: "never" (dense), or "auto", accepted only where the
    reference's static floor makes it dense (T*R*C below
    ``SPARSE_MIN_DENSE_WORK``). The sparse route is not ported yet.
    """
    if sparse not in ("auto", "never", "always"):
        raise ValueError(f"unknown sparse mode {sparse!r}")
    T = row_events_t.shape[0]
    R = row_events_t.shape[-1]
    C = weights.shape[-1]
    if sparse == "auto" and T * R * C < SPARSE_MIN_DENSE_WORK:
        sparse = "never"
    if sparse != "never":
        raise NotImplementedError(
            f"sparse={sparse!r} at T*R*C={T * R * C} needs the event-sparse "
            "path (core/events.py + the synray_sparse kernel), which is not "
            "ported yet; pass sparse='never'")
    return _dense_window(weights, addresses, row_events_t, event_addr_t,
                         gain, const_addr)


def quantize_weight(w_float):
    """Saturating 6-bit write (the PPU's vector-store semantics)."""
    return torch.clamp(torch.round(w_float), 0, WMAX).to(torch.int8)
