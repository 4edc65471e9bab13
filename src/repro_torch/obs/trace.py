"""Telemetry counters of the emulation, as device tensors.

``Telemetry`` is a NamedTuple of 0-d device tensors (int32 counters, two
float32 ones) and one fixed-size int32 histogram. It is threaded through
a run as the reference's pytree is (``repro/obs/trace.py``), and in the
§5 experiment it is part of the state (``ExperimentState.tele``) that a
captured trial graph carries from replay to replay. The contract that
makes it free when unused:

  * OFF is ``None``. Every update helper returns ``None`` for ``None``
    input and launches nothing, so a run with telemetry off launches
    exactly the kernels it launched before telemetry existed.
  * ON only reads: the counters are derived from values the emulation
    already computes (recorded spikes, the census the sparse route's gate
    already took, the VM's register file, the rule's weight delta). No
    operand of the emulation is touched, so spikes, weights and states
    are bit-identical with telemetry on.
  * No update reads the device from the host or copies host data to it
    (plan counts are Python scalars of a ``clamp``; the histogram's bin
    edges are put on the device once), so the helpers run inside a CUDA
    graph capture. ``summary`` is the only host read.
  * Every int32 counter counts whole things, and ``rate_total`` sums
    whole numbers below 2^24 a trial, so the sums are exact in any order
    and equal the reference's helpers given the same inputs.

Counters (the reference's catalogue): ``steps`` / ``trials``,
``in_events`` / ``out_spikes``, ``rate_total``, ``dense_windows`` /
``sparse_windows`` / ``gated_windows`` / ``overflow_fallbacks`` /
``census_events_max`` / ``census_k_max`` (the synaptic route's gate),
``routed_events`` / ``link_overflows`` / ``link_events_max`` /
``link_reroutes`` (the wafer bus, counted by ``wafer.InterChipRouter
.route``), ``vm_runs`` /
``vm_sat_hits``, ``dw_updates`` / ``dw_abs_max`` / ``dw_hist``, and the
gauges ``faults_injected`` / ``faults_detected`` / ``blacklisted_rows``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

# |dw| histogram bin edges in weight LSBs: bin 0 is "below one Q8.8 LSB"
# (effectively unchanged), the rest are log2-spaced up to the ±45 clip
# range of the §5 signed weights. searchsorted(E, x) -> bin index.
DW_EDGES = np.asarray([1.0 / 256, 1.0 / 64, 1.0 / 16, 0.25, 0.5,
                       1.0, 2.0, 4.0, 8.0, 16.0, 32.0], np.float32)
DW_BINS = len(DW_EDGES) + 1

_I32_FIELDS = ("steps", "trials", "in_events", "out_spikes",
               "dense_windows", "sparse_windows", "gated_windows",
               "overflow_fallbacks", "census_events_max", "census_k_max",
               "routed_events", "link_overflows", "link_events_max",
               "vm_runs", "vm_sat_hits", "dw_updates",
               "faults_injected", "faults_detected", "blacklisted_rows",
               "link_reroutes")


class Telemetry(NamedTuple):
    steps: torch.Tensor               # [] i32 integrated dt steps
    trials: torch.Tensor              # [] i32 completed trials
    in_events: torch.Tensor           # [] i32 nonzero input row events
    out_spikes: torch.Tensor          # [] i32 output spikes
    rate_total: torch.Tensor          # [] f32 rate counters at PPU reads
    dense_windows: torch.Tensor       # [] i32 windows routed dense
    sparse_windows: torch.Tensor      # [] i32 windows routed sparse
    gated_windows: torch.Tensor       # [] i32 census-gated windows
    overflow_fallbacks: torch.Tensor  # [] i32 census overflow -> dense
    census_events_max: torch.Tensor   # [] i32 worst gated window events
    census_k_max: torch.Tensor        # [] i32 worst gated per-step events
    routed_events: torch.Tensor       # [] i32 inter-chip events routed
    link_overflows: torch.Tensor      # [] i32 link censuses over budget
    link_events_max: torch.Tensor     # [] i32 worst per-link event count
    vm_runs: torch.Tensor             # [] i32 PPU-VM program executions
    vm_sat_hits: torch.Tensor         # [] i32 register lanes on the rails
    dw_updates: torch.Tensor          # [] i32 weight-update applications
    faults_injected: torch.Tensor     # [] i32 gauge: injected fault sites
    faults_detected: torch.Tensor     # [] i32 gauge: blacklist entries
    blacklisted_rows: torch.Tensor    # [] i32 gauge: blacklisted rows
    link_reroutes: torch.Tensor       # [] i32 events on failover forwards
    dw_abs_max: torch.Tensor          # [] f32 largest |dw| seen (LSBs)
    dw_hist: torch.Tensor             # [DW_BINS] i32 |dw| histogram


def init_telemetry(device) -> Telemetry:
    """All counters at zero on ``device``: one distinct tensor per field
    (a captured trial copies each into its own state tensor)."""
    def zero(dtype, shape=()):
        return torch.zeros(shape, dtype=dtype, device=device)
    return Telemetry(
        **{f: zero(torch.int32) for f in _I32_FIELDS},
        rate_total=zero(torch.float32), dw_abs_max=zero(torch.float32),
        dw_hist=zero(torch.int32, (DW_BINS,)))


def _nonzero(x) -> torch.Tensor:
    return torch.count_nonzero(x).to(torch.int32)


# ---------------------------------------------------------------------------
# Update helpers — every one is the identity on None (telemetry OFF)
# ---------------------------------------------------------------------------

def count_run(tele: Optional[Telemetry], row_spikes_t, out_spikes_t
              ) -> Optional[Telemetry]:
    """One integrated window: dt steps, input events, output spikes,
    read from the window's recorded inputs and outputs. Totals sum over
    any instance prefix."""
    if tele is None:
        return None
    return tele._replace(
        steps=tele.steps + row_spikes_t.shape[0],
        in_events=tele.in_events + _nonzero(row_spikes_t),
        out_spikes=tele.out_spikes + out_spikes_t.sum().to(torch.int32))


def count_route(tele: Optional[Telemetry], sparse: bool
                ) -> Optional[Telemetry]:
    """A statically routed synaptic window (no census gate): the
    ``sparse="never"`` / work-floor dense route, or forced ``"always"``."""
    if tele is None:
        return None
    if sparse:
        return tele._replace(sparse_windows=tele.sparse_windows + 1)
    return tele._replace(dense_windows=tele.dense_windows + 1)


def count_gate(tele: Optional[Telemetry], fits, n_events, k_max
               ) -> Optional[Telemetry]:
    """One ``sparse="auto"`` census-gate decision: ``fits`` routed sparse,
    ``~fits`` is a capacity-overflow fallback to dense. The three are the
    census tensor's elements (``kernels.census``), read on the device."""
    if tele is None:
        return None
    took = fits.to(torch.int32)
    return tele._replace(
        gated_windows=tele.gated_windows + 1,
        sparse_windows=tele.sparse_windows + took,
        dense_windows=tele.dense_windows + (1 - took),
        overflow_fallbacks=tele.overflow_fallbacks + (1 - took),
        census_events_max=torch.maximum(tele.census_events_max,
                                        n_events.to(torch.int32)),
        census_k_max=torch.maximum(tele.census_k_max,
                                   k_max.to(torch.int32)))


def count_links(tele: Optional[Telemetry], n_link, fits_link
                ) -> Optional[Telemetry]:
    """One inter-chip routing exchange: ``n_link`` the per-link event
    census ([L] integers), ``fits_link`` the per-link budget verdict ([L]
    bool). A link over budget is an overflow (``link_overflows``)."""
    if tele is None:
        return None
    n_link = n_link.to(torch.int32)
    return tele._replace(
        routed_events=tele.routed_events + n_link.sum().to(torch.int32),
        link_overflows=tele.link_overflows + _nonzero(~fits_link),
        link_events_max=torch.maximum(tele.link_events_max, n_link.max()))


def count_trial(tele: Optional[Telemetry], rate_counters
                ) -> Optional[Telemetry]:
    """One completed trial; ``rate_counters`` as read by the PPU (before
    the post-read reset)."""
    if tele is None:
        return None
    return tele._replace(
        trials=tele.trials + 1,
        rate_total=tele.rate_total
        + rate_counters.sum().to(torch.float32))


def count_vm(tele: Optional[Telemetry], regs) -> Optional[Telemetry]:
    """One PPU-VM program execution: final register lanes resting on the
    Q8.8 saturation rails (0x7FFF / 0x8000), read from the register file
    the executor returns."""
    if tele is None:
        return None
    from repro_torch.ppuvm import isa
    on_rail = (regs == isa.I16MAX) | (regs == isa.I16MIN)
    return tele._replace(vm_runs=tele.vm_runs + 1,
                         vm_sat_hits=tele.vm_sat_hits + _nonzero(on_rail))


# the bin edges per device, put there once (a trial builds nothing from
# host data)
_EDGES = {}


def _dw_edges(device) -> torch.Tensor:
    device = torch.device(device)
    if device not in _EDGES:
        _EDGES[device] = torch.as_tensor(DW_EDGES, device=device)
    return _EDGES[device]


def count_dw(tele: Optional[Telemetry], w_old, w_new
             ) -> Optional[Telemetry]:
    """One weight update: |dw| magnitude histogram over all synapses
    (weight-LSB units; bin edges ``DW_EDGES``), binned as the left side
    of ``searchsorted`` (``jnp.searchsorted``'s default): bin b holds the
    values above exactly b edges. Each edge's count of values above it is
    one comparison and one integer sum, and the bins are the differences
    of those counts: exact, in any order, with no read of the host and no
    atomic additions contending for twelve addresses."""
    if tele is None:
        return None
    dw = (w_new.to(torch.float32) - w_old.to(torch.float32)).abs().reshape(-1)
    above = (dw.unsqueeze(1) > _dw_edges(dw.device)).sum(0, dtype=torch.int32)
    n = torch.full((1,), dw.numel(), dtype=torch.int32, device=dw.device)
    bins = torch.cat([n, above]) - torch.cat([above, n.new_zeros(1)])
    return tele._replace(
        dw_updates=tele.dw_updates + 1,
        dw_abs_max=torch.maximum(tele.dw_abs_max, dw.max()),
        dw_hist=tele.dw_hist + bins)


def count_faults(tele: Optional[Telemetry], faults) -> Optional[Telemetry]:
    """Announce the threaded fault overlays: gauges raised with a
    ``clamp`` to the plans' host counts, so every hook site reports the
    same totals without double counting. Injection plans land in
    ``faults_injected`` (their active site count), blacklist reductions
    in ``faults_detected`` / ``blacklisted_rows``. ``faults``: the
    overlay as ``FaultPlan``s or as the device plans of
    ``repro_torch.faults.inject.on_device`` (both carry the counts)."""
    if tele is None or faults is None:
        return tele
    from repro_torch.faults.model import as_plans
    inj = det = rows = 0
    for p in as_plans(faults):
        if p.is_blacklist:
            det += p.total_sites
            rows += p.n_dead_rows
        else:
            inj += p.total_sites
    if inj:
        tele = tele._replace(
            faults_injected=tele.faults_injected.clamp(min=inj))
    if det:
        tele = tele._replace(
            faults_detected=tele.faults_detected.clamp(min=det),
            blacklisted_rows=tele.blacklisted_rows.clamp(min=rows))
    return tele


def count_reroutes(tele: Optional[Telemetry], n_fwd) -> Optional[Telemetry]:
    """One routing exchange's failover traffic: ``n_fwd`` the event
    census of the forward-rule deliveries. Identity on ``None`` telemetry
    or when there are no forward rules (``n_fwd is None``)."""
    if tele is None or n_fwd is None:
        return tele
    return tele._replace(
        link_reroutes=tele.link_reroutes + n_fwd.to(torch.int32))


# ---------------------------------------------------------------------------
# Host-side summary
# ---------------------------------------------------------------------------

def summary(tele: Optional[Telemetry]) -> Optional[dict]:
    """The counters on the host as plain Python numbers (the form the run
    report embeds). The only host read of the counters: emitting a report
    touches no captured program."""
    if tele is None:
        return None
    d = {k: v.tolist() for k, v in tele._asdict().items()}
    d["dw_hist_edges"] = DW_EDGES.tolist()
    return d
