"""Fault-injection hooks threaded through the emulation stack.

Each hook takes the ``faults`` overlay and one value of the existing
dataflow, and returns that value with the plans' defects applied in
order (``repro/faults/inject.py``, at the same sites):

  * ``faults=None``, or a plan without the hook's field, launches
    nothing: the hook returns its argument object itself, so the
    fault-free program is the one that ran before the subsystem existed.
  * A plan's arrays are put on the device once, where the core or the
    vector unit is built (``on_device``: a tuple of ``DevicePlan``s).
    A hook given host ``FaultPlan``s converts them at the call, a copy
    from the host that a captured trial graph refuses; the emulation
    passes device plans.
  * Hook placement gives every backend the same fault semantics (the
    windowed backends apply per window what the oracle applies per dt).

Hook sites:

  rows      ``AnnCore.run`` / ``step`` entry — dead drivers zero their
            events before STP, the census, the synaptic product and the
            correlation pre-traces.
  weights   the analog synapse read (``step`` / ``_window_currents``):
            stuck SRAM cells override the stored value each time the
            crossbar is read; PPU writes still land in the array.
  spikes    after the neuron phase, before the rate counters and the
            correlation window: hot drivers force 1, dead drivers 0. The
            membrane keeps integrating unmasked.
  rates     the windowed backends' rate-counter fixup matching what the
            oracle accumulates per step from hooked spikes.
  cadc      ``VectorUnit.read_correlation`` — code offsets then stuck
            codes, clipped to the ADC range (``cadc_map`` folds a chain
            of them into one clamp-shift per column for ``ppu_update``).
  store     ``VectorUnit.run_program_fixed`` — XOR bit-flips then the
            blacklist zero-mask on every PPU-VM weight store.
  links     per-link delivery grids of the wafer router
            (``wafer.InterChipRouter``), before the budget census.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.faults.model import FaultPlan, as_plans


@dataclass(frozen=True, eq=False)
class DevicePlan:
    """A ``FaultPlan``'s arrays as tensors on one device, with the masks
    the hooks multiply by made once (``alive_rows`` / ``alive_neurons``
    float32, 1 where the driver works), and the plan's host counts for
    ``obs.trace.count_faults``. Build with ``on_device``."""

    plan: FaultPlan
    alive_rows: Optional[torch.Tensor]
    hot_neurons: Optional[torch.Tensor]
    alive_neurons: Optional[torch.Tensor]
    stuck_w_mask: Optional[torch.Tensor]
    stuck_w_val: Optional[torch.Tensor]
    cadc_stuck_mask: Optional[torch.Tensor]
    cadc_stuck_code: Optional[torch.Tensor]
    cadc_code_offset: Optional[torch.Tensor]
    store_flip: Optional[torch.Tensor]
    store_zero: Optional[torch.Tensor]
    dead_links: Optional[torch.Tensor]
    flaky_links: Optional[torch.Tensor]

    @classmethod
    def build(cls, plan: FaultPlan, device) -> "DevicePlan":
        def put(x):
            return None if x is None else torch.as_tensor(x, device=device)

        def alive(x):
            return None if x is None else torch.as_tensor(
                ~x, device=device).to(torch.float32)
        p = plan
        return cls(plan=p, alive_rows=alive(p.dead_rows),
                   hot_neurons=put(p.hot_neurons),
                   alive_neurons=alive(p.dead_neurons),
                   **{f: put(getattr(p, f)) for f in (
                       "stuck_w_mask", "stuck_w_val", "cadc_stuck_mask",
                       "cadc_stuck_code", "cadc_code_offset", "store_flip",
                       "store_zero", "dead_links", "flaky_links")})

    # the plan's host census, for the telemetry gauges
    @property
    def is_blacklist(self) -> bool:
        return self.plan.is_blacklist

    @property
    def total_sites(self) -> int:
        return self.plan.total_sites

    @property
    def n_dead_rows(self) -> int:
        return self.plan.n_dead_rows

    @property
    def seed(self) -> int:
        return self.plan.seed


def _plans(faults, device):
    """The overlay's plans as device plans on ``device``: the given
    device plans, or host plans converted at the call."""
    for p in as_plans(faults):
        yield p if isinstance(p, DevicePlan) else DevicePlan.build(p, device)


def on_device(faults, device):
    """The overlay (``None`` | ``FaultPlan`` | sequence of either) as a
    tuple of ``DevicePlan``s on ``device``, in application order, or
    ``None`` when no plan is active."""
    return tuple(_plans(faults, device)) or None


def rows(faults, row_spikes_t):
    """[T?, .., R] driver events — dead rows forward nothing."""
    for p in _plans(faults, row_spikes_t.device):
        if p.alive_rows is not None:
            row_spikes_t = row_spikes_t * p.alive_rows.to(row_spikes_t.dtype)
    return row_spikes_t


def weights(faults, w):
    """[.., R, C] synapse weights at the analog read."""
    for p in _plans(faults, w.device):
        if p.stuck_w_mask is not None:
            w = torch.where(p.stuck_w_mask, p.stuck_w_val.to(w.dtype), w)
    return w


def spikes(faults, out_spikes):
    """[T?, .., C] neuron output spikes — hot forces 1, dead forces 0."""
    for p in _plans(faults, out_spikes.device):
        if p.hot_neurons is not None:
            out_spikes = out_spikes.masked_fill(p.hot_neurons, 1.0)
        if p.alive_neurons is not None:
            out_spikes = out_spikes * p.alive_neurons.to(out_spikes.dtype)
    return out_spikes


def rates(faults, rc, rc_in, n_steps: int):
    """Window-level twin of ``spikes`` for the rate counters: ``rc`` is
    the raw windowed accumulation ``rc_in + sum(raw spikes)``; a hot
    column accumulated exactly ``n_steps`` hooked spikes, a dead column
    zero (its carry-in is zero by induction)."""
    for p in _plans(faults, rc.device):
        if p.hot_neurons is not None:
            rc = torch.where(p.hot_neurons, rc_in + float(n_steps), rc)
        if p.alive_neurons is not None:
            rc = rc * p.alive_neurons.to(rc.dtype)
    return rc


def cadc(faults, qc, qa, cadc_max: int):
    """[.., R, C] CADC codes: additive code errors then stuck codes.
    Column planes broadcast over the row axis."""
    for p in _plans(faults, qc.device):
        if p.cadc_code_offset is not None:
            off = p.cadc_code_offset.unsqueeze(-2)
            qc = torch.clamp(qc + off, 0, cadc_max)
            qa = torch.clamp(qa + off, 0, cadc_max)
        if p.cadc_stuck_mask is not None:
            m = p.cadc_stuck_mask.unsqueeze(-2)
            code = p.cadc_stuck_code.unsqueeze(-2)
            qc = torch.where(m, code, qc)
            qa = torch.where(m, code, qa)
    return qc, qa


def cadc_map(faults, device, cadc_max: int):
    """The overlay's CADC hooks folded per column into one clamp-shift,
    ``q -> min(max(q + a, lo), hi)``, equal to ``cadc`` on every code in
    [0, cadc_max]: an offset stage maps (a, lo, hi) to (a + off,
    clip(lo + off), clip(hi + off)) and a stuck column to (0, code,
    code). Returns float32 ``(a, lo, hi)`` [.., C] tensors for the
    ``ppu_update`` kernel, or ``None`` when no plan has a CADC field."""
    plans = [p for p in _plans(faults, device)
             if p.cadc_code_offset is not None
             or p.cadc_stuck_mask is not None]
    if not plans:
        return None
    i32 = dict(dtype=torch.int32, device=device)
    a = torch.zeros((), **i32)
    lo = torch.zeros((), **i32)
    hi = torch.full((), cadc_max, **i32)
    for p in plans:
        if p.cadc_code_offset is not None:
            off = p.cadc_code_offset
            a = a + off
            lo = torch.clamp(lo + off, 0, cadc_max)
            hi = torch.clamp(hi + off, 0, cadc_max)
        if p.cadc_stuck_mask is not None:
            m, code = p.cadc_stuck_mask, p.cadc_stuck_code
            a = torch.where(m, 0, a)
            lo = torch.where(m, code, lo)
            hi = torch.where(m, code, hi)
    a, lo, hi = torch.broadcast_tensors(a, lo, hi)
    return tuple(x.to(torch.float32).contiguous() for x in (a, lo, hi))


def store(faults, w_new):
    """[.., R, C] int32 weights on the PPU-VM store path (before the
    6-bit cast): XOR bit-flips, then the blacklist zero-mask."""
    for p in _plans(faults, w_new.device):
        if p.store_flip is not None:
            w_new = torch.bitwise_xor(w_new, p.store_flip.to(w_new.dtype))
        if p.store_zero is not None:
            w_new = w_new.masked_fill(p.store_zero, 0)
    return w_new


def _hash_u32(x):
    """Deterministic 32-bit integer mix (splitmix-style finalizer), on
    int64 tensors holding uint32 values (PyTorch has no uint32 multiply
    on every device): each product is taken modulo 2^32."""
    m = 0xFFFFFFFF
    x = ((x ^ (x >> 16)) * 0x7feb352d) & m
    x = ((x ^ (x >> 15)) * 0x846ca68b) & m
    return x ^ (x >> 16)


def link_keep(p, T: int, R: int, link_ids):
    """[T, Lx, R] keep factor for one plan's link faults: 0.0 on dead
    links; on flaky links a per-(t, link, row) deterministic coin hashed
    from (t, row, absolute link id, plan seed), as the reference's."""
    dev = p.dead_links.device if p.dead_links is not None else (
        p.flaky_links.device)
    lid = torch.as_tensor(link_ids, dtype=torch.int64, device=dev)
    keep = None
    m = 0xFFFFFFFF
    if p.flaky_links is not None:
        fl = p.flaky_links[lid]                            # [Lx]
        tr = (torch.arange(T, dtype=torch.int64, device=dev)[:, None, None]
              * R + torch.arange(R, dtype=torch.int64, device=dev)
              [None, None, :]) & m
        h = _hash_u32(((tr * 0x9e3779b1) & m)
                      + (((lid[None, :, None] + 1) * 0x85ebca77) & m)
                      + (p.seed & m) & m)
        h = h & m
        u = (h >> 8).to(torch.float32) * (1.0 / (1 << 24))
        keep = (u >= fl[None, :, None]).to(torch.float32)
    if p.dead_links is not None:
        alive = (~p.dead_links).to(torch.float32)[lid][None, :, None]
        keep = alive if keep is None else keep * alive
    return keep


def links(faults, grids, link_ids):
    """[T, Lx, R] per-link delivery grids; ``link_ids`` are the absolute
    link indices of the Lx slots."""
    plans = [p for p in _plans(faults, grids.device)
             if p.dead_links is not None or p.flaky_links is not None]
    if not plans:
        return grids
    T, R = grids.shape[0], grids.shape[2]
    for p in plans:
        keep = link_keep(p, T, R, link_ids)
        if keep is not None:
            grids = grids * keep
    return grids


def has_link_faults(faults) -> bool:
    return any(p.dead_links is not None or p.flaky_links is not None
               for p in as_plans(faults))

