"""Commissioning-style screening and graceful degradation.

Probe stimuli run against the (possibly faulted) chip, the observables the
real system has (rate counters, CADC codes) are censused, and a
``Blacklist`` of unusable rows and neurons is derived
(``repro/faults/blacklist.py``). Degradation is then exact by
construction: ``Blacklist.as_faults`` turns the blacklist into a
reduction ``FaultPlan`` (blacklisted rows become dead rows, blacklisted
neurons dead neurons with their CADC columns pinned to the code a zero
accumulator digitizes to, every blacklisted synapse's PPU-VM store forced
to zero). Threading ``chain(faults, blacklist.as_faults(...))`` emulates
the faulted chip under its blacklist, bit-identical to the clean reduced
network (``chain(blacklist.as_faults(...))`` alone), as long as the
blacklist covers the fault sites.

The probes run ``core.run`` and ``ppu.read_correlation`` on the core's
device, the link probe the router's census on the router's device; the
host reads their results once, for the verdict. A blacklist's links
reroute a wafer plan around them (``core.hybrid.make_experiment``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import numpy as np
import torch

from repro_torch.faults.model import FaultPlan


def cadc_zero_code(inst, cadc_bits: int = 8) -> np.ndarray:
    """[.., C] code a zero correlation accumulator digitizes to under the
    instance's calibration (``cadc.digitize(0) = clip(round(offset))``),
    on the host: the baseline every CADC probe compares against."""
    off = np.asarray(torch.as_tensor(inst["cadc_offset"]).cpu(), np.float64)
    return np.clip(np.round(off), 0, 2 ** cadc_bits - 1).astype(np.int32)


@dataclass(frozen=True)
class Blacklist:
    """Per-neuron / per-row / per-link screening verdict (host numpy).

    ``rows`` [.., R] / ``neurons`` [.., C] bool follow the core's
    instance-prefix shapes; ``links`` are (src_chip, dst_chip) pairs.
    ``as_faults`` is the run-time reduction (faulted-under-blacklist ==
    clean reduced network, ``tests/test_torch_faults.py``)."""
    rows: np.ndarray
    neurons: np.ndarray
    links: Tuple[Tuple[int, int], ...] = field(default_factory=tuple)

    def __post_init__(self):
        object.__setattr__(self, "rows", np.asarray(self.rows, bool))
        object.__setattr__(self, "neurons", np.asarray(self.neurons, bool))
        object.__setattr__(self, "links",
                           tuple((int(s), int(d)) for s, d in self.links))

    @property
    def n_rows(self) -> int:
        return int(self.rows.sum())

    @property
    def n_neurons(self) -> int:
        return int(self.neurons.sum())

    @property
    def n_links(self) -> int:
        return len(self.links)

    @property
    def total(self) -> int:
        return self.n_rows + self.n_neurons + self.n_links

    def union(self, other: "Blacklist") -> "Blacklist":
        return Blacklist(rows=self.rows | other.rows,
                         neurons=self.neurons | other.neurons,
                         links=tuple(sorted(set(self.links)
                                            | set(other.links))))

    def as_faults(self, inst, cadc_bits: int = 8) -> FaultPlan:
        """The graceful-degradation reduction overlay. ``store_zero``
        covers the union of blacklisted rows and columns so VM stores
        cannot resurrect masked synapses."""
        zero = (self.rows[..., :, None] | self.neurons[..., None, :])
        return FaultPlan(
            dead_rows=self.rows if self.n_rows else None,
            dead_neurons=self.neurons if self.n_neurons else None,
            cadc_stuck_mask=self.neurons if self.n_neurons else None,
            cadc_stuck_code=(cadc_zero_code(inst, cadc_bits)
                             if self.n_neurons else None),
            store_zero=zero if zero.any() else None,
            is_blacklist=True)


def screen_chip(core, ppu, probe_steps: int = 64, margin: int = 2,
                drive_weight: int = 63) -> Blacklist:
    """Screen one (possibly faulted) core + vector unit with the two
    commissioning probes:

      silent probe   no stimulus: neurons that still fire are HOT; CADC
                     columns whose codes stray more than ``margin`` from
                     the calibrated zero baseline are corrupted readouts.
      drive probe    every row fires every dt with excitatory weights at
                     ``drive_weight``: healthy neurons must spike (DEAD
                     otherwise), and every healthy driver row must show
                     causal CADC signal on the healthy columns — rows
                     stuck at the zero baseline are dead drivers.

    The probes run through the same faulted observables a production run
    sees (``core.run`` + ``ppu.read_correlation``), on the core's device:
    the state, the events and the full-drive weight plane are made there.
    """
    cfg = core.cfg
    R, C = cfg.n_rows, cfg.n_cols
    dev = core.device
    base = cadc_zero_code(ppu.inst, cfg.cadc_bits)      # [.., C]
    prefix = base.shape[:-1]

    def probe(ev_value, drive):
        st = core.init_state(prefix)
        if drive:
            w = torch.zeros((*prefix, R, C), dtype=torch.int8, device=dev)
            w[..., 0::2, :] = drive_weight
            st = st._replace(syn=st.syn._replace(weights=w))
        ev = torch.full((probe_steps, *prefix, R), ev_value,
                        dtype=torch.float32, device=dev)
        ad = torch.zeros((probe_steps, *prefix, R), dtype=torch.int8,
                         device=dev)
        st, _ = core.run(st, ev, ad)
        qc, qa = ppu.read_correlation(st.corr)
        return (st.rate_counters.cpu().numpy(), qc.cpu().numpy(),
                qa.cpu().numpy())

    # silent probe: hot neurons + corrupted CADC columns
    rates0, qc0, qa0 = probe(0.0, False)
    hot = rates0 > 0.0
    dev0 = np.maximum(np.abs(qc0 - base[..., None, :]),
                      np.abs(qa0 - base[..., None, :])).max(axis=-2)
    cadc_bad = dev0 > margin

    # drive probe: excitatory rows at full weight (odd/inhibitory rows
    # stay at zero weight but still forward events, so their drivers
    # leave causal traces too)
    rates1, qc1, _ = probe(1.0, True)
    dead_n = (rates1 <= 0.0) & ~hot

    neurons = hot | dead_n | cadc_bad
    good = ~neurons                                     # [.., C]
    if not good.any():
        # nothing to measure rows against — refuse to guess
        return Blacklist(rows=np.zeros((*prefix, R), bool),
                         neurons=neurons)
    delta = qc1 - base[..., None, :]                    # [.., R, C]
    dead_rows = np.where(good[..., None, :], delta,
                         0).max(axis=-1) <= margin
    return Blacklist(rows=dead_rows, neurons=neurons)


def screen_links(router, probe_steps: int = 32,
                 min_ratio: float = 0.95) -> Tuple[Tuple[int, int], ...]:
    """Screen the inter-chip bus: every column spiking every dt, the
    faulted router's per-link delivered census against a clean router's
    on the same plan, both on the router's device (read back once). A
    link delivering less than ``min_ratio`` of its expected census is
    dead or flaky: returned as (src_chip, dst_chip) pairs for the
    blacklist."""
    from repro_torch.wafer.router import InterChipRouter
    out = torch.ones((probe_steps, router.K_loc, router.C),
                     dtype=torch.float32, device=router.device)
    clean = InterChipRouter(router.plan, device=router.device,
                            link_budget=router.link_budget,
                            link_step_budget=router.link_step_budget,
                            link_mode=router.link_mode, group=router.group)
    n_f, n_c = torch.stack([router.link_census(out),
                            clean.link_census(out)]).cpu().numpy()
    bad = (n_c > 0) & (n_f < min_ratio * n_c)
    links = router.plan.topology.links()
    return tuple(links[l] for l in np.nonzero(bad)[0])


def screen(core, ppu, router=None, probe_steps: int = 64,
           margin: int = 2, min_ratio: float = 0.95) -> Blacklist:
    """Full screening pass: the two chip probes (``screen_chip``) and,
    with a router, the link census probe (``screen_links``).

    Args:
      core / ppu: the (possibly faulted) ``AnnCore`` and ``VectorUnit``,
        e.g. ``meta["core"]`` / ``meta["ppu"]`` of a ``run_training``.
      router: an ``InterChipRouter`` (``meta["router"]`` in wafer mode)
        for the link census, or ``None``.
      probe_steps: probe window length (the links take ``min(., 32)``).
      margin: CADC code tolerance before a column is flagged.
      min_ratio: delivered / expected events below which a link is
        flagged.

    Returns:
      A ``Blacklist`` covering the detected rows, neurons and links.
    """
    bl = screen_chip(core, ppu, probe_steps=probe_steps, margin=margin)
    if router is not None:
        bl = Blacklist(rows=bl.rows, neurons=bl.neurons,
                       links=screen_links(router, min(probe_steps, 32),
                                          min_ratio))
    return bl
