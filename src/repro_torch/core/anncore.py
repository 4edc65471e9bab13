"""The assembled analog network core (anncore).

One object holds the machine's parameters (config + virtual instance) and
``run`` integrates the state (neurons, synapses, STP, correlation sensors)
over a time window. Everything broadcasts over a leading instance prefix,
so a fleet of independent chips runs as one program.

Backends (``repro/core/anncore.py`` has the same three):

``oracle``
    The literal per-dt loop of ``step``: every step recomputes the
    address-match mask and updates the [.., R, C] correlation
    accumulators. Ground truth for the equivalence tests.

``fused`` (the ``auto`` pick on the CPU)
    STP efficacy trajectory first (it depends only on the input events;
    ``stp_scan``, which also takes both Dale halves' censuses where the
    sparse route's gate decides them),
    then the whole window's synaptic currents as one time-batched product
    per Dale half (``synray``), a neuron-only dt loop, and the
    correlation-sensor window replayed once (``corr``).

``blocked`` (the ``auto`` pick on a CUDA device)
    ``fused`` with the neuron loop replaced by the whole-window
    ``neuron_scan`` (the CUDA kernel on the card, its plain version on the
    CPU). Spikes are bit-identical to the oracle: the per-step op trees
    are shared (``adex.integrate_currents`` / ``membrane_step``).

Fault overlays (``faults=``, ``repro_torch.faults``) and telemetry
(``telemetry=``, ``repro_torch.obs.trace``) come in at the reference's
sites: the ``rows`` hook and the fault gauges at the entry of ``run``,
the ``weights`` hook at the analog read, the ``spikes`` / ``rates`` hooks
after the neuron window and before the correlation window, the route
counters in the synaptic window and ``count_run`` at the end. Off (the
defaults), ``run`` launches what it launched before they existed.

``run_routed`` closes the wafer's inter-chip router
(``repro_torch.wafer``) around ``run``: last window's routed events merge
into the inputs, this window's spikes go on the bus.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from repro_torch.configs.bss2 import BSS2Config
from repro_torch.core import adex, correlation, stp, synapse
from repro_torch.faults import inject as finject
from repro_torch.obs import trace as obs_trace


class AnnCoreState(NamedTuple):
    neuron: adex.NeuronState
    stp: stp.STPState
    corr: correlation.CorrelationState
    syn: synapse.SynapseArray
    rate_counters: torch.Tensor    # [..., C] spike counts since last read


class AnnCore:
    """Integrator bound to a config and a virtual instance.

    ``inst`` carries the mismatch realisation (``repro_torch.verif
    .mismatch``), its tensors on the device the core runs on.
    ``backend``: "auto" | "oracle" | "fused" | "blocked"; "auto" resolves
    to "blocked" when the instance lies on a CUDA device and to "fused" on
    the CPU. ``const_addr``: promise that within a window each row's event
    address never changes (lets the CPU path resolve the mask once).
    ``sparse_mode``: the synaptic route of each Dale half ("auto" |
    "never" | "always", see ``synapse.synaptic_current_window``), with
    the default capacities.
    ``telemetry``: when True, ``run`` starts a fresh
    ``obs.trace.Telemetry`` per call unless the caller passes one, and
    returns it under ``outputs["telemetry"]``; on/off outputs are
    bit-identical.
    ``faults``: a ``repro_torch.faults`` overlay (``None`` | ``FaultPlan``
    | sequence, injection first, blacklist reduction last), put on the
    core's device here, once (``faults.inject.on_device``); every backend
    gives the same outputs under it.
    """

    def __init__(self, cfg: BSS2Config, inst: Dict, backend: str = "auto",
                 const_addr: bool = False, sparse_mode: str = "auto",
                 telemetry: bool = False, faults=None):
        self.cfg = cfg
        self.inst = inst
        self.device = inst["weight_gain"].device
        self.telemetry = telemetry
        self.faults = finject.on_device(faults, self.device)
        if backend == "auto":
            backend = "blocked" if self.device.type == "cuda" else "fused"
        if backend not in ("oracle", "fused", "blocked"):
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        self.const_addr = const_addr
        self.sparse_mode = sparse_mode
        # the column count each window's route is planned from: the
        # chip's own, or the whole chip's where this core runs a column
        # part of it (``hybrid.column_part``), so that a part takes the
        # whole chip's routes, capacities and launches
        self.plan_cols = cfg.n_cols
        params = inst["neuron_params"]
        # loop-invariant terms, computed once per core (bit-exact hoists:
        # the op trees are the ones the per-step functions would run). The
        # decays' exp runs on the host, so a core on the card and one on
        # the CPU integrate with the same bits.
        self.decays = {k: v.to(self.device) for k, v in adex.decay_factors(
            {k: v.cpu() for k, v in params.items()}, cfg.dt).items()}
        self.stp_scale = stp.efficacy_scale(inst["stp_offset"],
                                            inst["stp_calib"])
        self.stp_recovery = stp.recovery_factor(cfg.stp_tau_rec, cfg.dt)
        self._packed = None

    def init_state(self, prefix=()) -> AnnCoreState:
        cfg, dev = self.cfg, self.device
        r, c = cfg.n_rows, cfg.n_cols
        return AnnCoreState(
            neuron=adex.init_state((*prefix, c), self.inst["neuron_params"]),
            stp=stp.init_state((*prefix, r), dev),
            corr=correlation.init_state(prefix, r, c, dev),
            syn=synapse.init_array(prefix, r, c, dev),
            rate_counters=torch.zeros((*prefix, c), dtype=torch.float32,
                                      device=dev),
        )

    def step(self, state: AnnCoreState, row_spikes, row_addr):
        """One dt of the full core (the oracle semantics).

        row_spikes: [..., R] float {0,1} events entering the drivers;
        row_addr:   [..., R] int8 event addresses.
        """
        cfg = self.cfg
        dt = cfg.dt
        row_spikes = finject.rows(self.faults, row_spikes)
        eff = stp.efficacy(state.stp, row_spikes, u=cfg.stp_u,
                           scale=self.stp_scale)
        new_stp = stp.update(state.stp, row_spikes, u=cfg.stp_u,
                             recovery=self.stp_recovery)
        # signed rows: even rows excitatory, odd rows inhibitory (Dale);
        # stuck SRAM cells override the stored weight at the analog read
        w = finject.weights(self.faults, state.syn.weights)
        a = state.syn.addresses
        gain = self.inst["weight_gain"]
        i_exc = synapse.synaptic_current(w[..., 0::2, :], a[..., 0::2, :],
                                         eff[..., 0::2], row_addr[..., 0::2],
                                         gain)
        i_inh = synapse.synaptic_current(w[..., 1::2, :], a[..., 1::2, :],
                                         eff[..., 1::2], row_addr[..., 1::2],
                                         gain)
        new_neuron, out_spikes = adex.step(
            state.neuron, i_exc * 60.0, i_inh * 60.0,
            self.inst["neuron_params"], dt, adex=cfg.neuron.adex,
            decays=self.decays)
        # output-driver faults: hot forces 1, dead forces 0, before the
        # sensors and counters; the membrane keeps integrating unmasked
        out_spikes = finject.spikes(self.faults, out_spikes)
        new_corr = correlation.update(
            state.corr, row_spikes, out_spikes,
            tau_pre=cfg.neuron.tau_syn_exc,
            tau_post=cfg.neuron.tau_syn_exc, dt=dt)
        new_state = AnnCoreState(
            neuron=new_neuron, stp=new_stp, corr=new_corr, syn=state.syn,
            rate_counters=state.rate_counters + out_spikes)
        return new_state, out_spikes

    def run(self, state: AnnCoreState, row_spikes_t, row_addr_t,
            record_v: bool = False, telemetry=None):
        """Integrate a [T, ..., R] event stream. Returns (state, outputs)
        with outputs = dict(spikes=[T, ..., C], v=[T, ..., C] if
        record_v, telemetry=Telemetry if counting).

        ``telemetry``: a ``Telemetry`` to add this window's counts to (the
        experiment threads its own through the trials), or ``None``: a
        fresh one if the core was built with ``telemetry=True``, else off.
        """
        if telemetry is None and self.telemetry:
            telemetry = obs_trace.init_telemetry(self.device)
        # dead drivers zero their events before every phase (STP, census,
        # synaptic product, correlation pre-traces, telemetry); applying
        # the hook again inside the oracle's ``step`` changes nothing
        row_spikes_t = finject.rows(self.faults, row_spikes_t)
        telemetry = obs_trace.count_faults(telemetry, self.faults)
        if self.backend == "oracle":
            return self._run_oracle(state, row_spikes_t, row_addr_t,
                                    record_v, telemetry)
        return self._run_windowed(state, row_spikes_t, row_addr_t, record_v,
                                  telemetry)

    def run_routed(self, state: AnnCoreState, routed_ev, row_spikes_t,
                   row_addr_t, router, record_v: bool = False,
                   telemetry=None):
        """One window with the inter-chip router closed around it
        (``repro/core/anncore.py:251-295``).

        ``routed_ev`` is the [T, K, R] delivery grid the previous window's
        spikes deposited (``router.init_buffer(T)`` for the first): it
        merges into this window's external inputs ``row_spikes_t`` /
        ``row_addr_t`` ([T, K, R]) before integration, and this window's
        spikes are routed into ``outputs["routed"]`` for the next window,
        with ``routed_ev`` feeding the plan's forward rules. The router's
        link counters land in the same ``outputs["telemetry"]`` as the
        emulation's. Returns ``(state, outputs)`` as ``run`` does."""
        if telemetry is None and self.telemetry:
            telemetry = obs_trace.init_telemetry(self.device)
        ev, ad = router.merge(routed_ev, row_spikes_t, row_addr_t)
        state, out = self.run(state, ev, ad, record_v=record_v,
                              telemetry=telemetry)
        routed, tele = router.route(out["spikes"],
                                    out.get("telemetry", telemetry),
                                    routed_in=routed_ev)
        out["routed"] = routed
        if tele is not None:
            out["telemetry"] = tele
        return state, out

    def _run_oracle(self, state, row_spikes_t, row_addr_t, record_v,
                    telemetry=None):
        spikes, vs = [], []
        for t in range(row_spikes_t.shape[0]):
            state, out = self.step(state, row_spikes_t[t], row_addr_t[t])
            spikes.append(out)
            if record_v:
                vs.append(state.neuron.v)
        out = dict(spikes=torch.stack(spikes))
        if record_v:
            out["v"] = torch.stack(vs)
        if telemetry is not None:
            # the oracle runs every step through the dense product
            out["telemetry"] = obs_trace.count_run(telemetry, row_spikes_t,
                                                   out["spikes"])
        return state, out

    def _window_currents(self, state: AnnCoreState, row_spikes_t,
                         row_addr_t, telemetry=None):
        """Phases 1+2 of the fused and blocked backends: the STP efficacy
        trajectory (``stp_scan``: one launch on the card, the step loop on
        the CPU) and the window's synaptic currents, one product per Dale
        half on strided row views of the weights as the crossbar reads
        them (the store, or the ``weights`` hook's copy of it). Both
        halves' routes are planned from the shapes first
        (``synapse.route_plan``, over ``plan_cols`` columns); where both
        are the census gate, the scan takes each half's census as it
        writes the efficacies and counts both decisions (no census
        kernel), and each half's window routes on its census. Returns
        ``(stp_state, i_exc_t, i_inh_t, telemetry)``."""
        from repro_torch.kernels.stp_scan import ops as stp_ops
        cfg = self.cfg
        syn = state.syn
        gain = self.inst["weight_gain"]
        w = finject.weights(self.faults, syn.weights)
        kw = dict(const_addr=self.const_addr, sparse=self.sparse_mode)
        T, R = row_spikes_t.shape[0], row_spikes_t.shape[-1]
        plans = [synapse.route_plan(T, len(range(h, R, 2)), self.plan_cols,
                                    **kw) for h in (0, 1)]
        kw["plan_cols"] = self.plan_cols
        caps = routes = None
        if all(route == "gate" for route, _, _ in plans):
            caps = tuple(p[1:] for p in plans)
            routes = synapse.route_counts(row_spikes_t.device)
        eff_t, r_t, *census = stp_ops.stp_scan(
            state.stp.r, row_spikes_t.to(torch.float32), self.stp_scale,
            u=cfg.stp_u, recovery=self.stp_recovery, caps=caps,
            routes=routes)
        census = census or (None, None)
        s = stp.STPState(r=r_t)

        i_exc_t = synapse.synaptic_current_window(
            w[..., 0::2, :], syn.addresses[..., 0::2, :],
            eff_t[..., 0::2], row_addr_t[..., 0::2], gain,
            telemetry=telemetry, census=census[0], **kw)
        if telemetry is not None:
            i_exc_t, telemetry = i_exc_t
        i_inh_t = synapse.synaptic_current_window(
            w[..., 1::2, :], syn.addresses[..., 1::2, :],
            eff_t[..., 1::2], row_addr_t[..., 1::2], gain,
            telemetry=telemetry, census=census[1], **kw)
        if telemetry is not None:
            i_inh_t, telemetry = i_inh_t
        return s, i_exc_t * 60.0, i_inh_t * 60.0, telemetry

    def _neuron_window(self, neuron, rate_counters, i_exc_t, i_inh_t,
                       record_v: bool):
        """Phase 3: membrane integration over the currents. Returns
        ``(new_neuron, rate_counters, recs)``."""
        cfg, params = self.cfg, self.inst["neuron_params"]
        if self.backend == "blocked":
            from repro_torch.kernels.neuron_scan import ops as neuron_ops
            cshape = tuple(i_exc_t.shape[1:])
            if self._packed is None or self._packed[0] != cshape:
                self._packed = (cshape, neuron_ops.pack_params(
                    params, self.decays, cshape))
            return neuron_ops.neuron_window(
                neuron, rate_counters, i_exc_t, i_inh_t, params, dt=cfg.dt,
                use_adex=cfg.neuron.adex, decays=self.decays,
                record_v=record_v, packed_params=self._packed[1])
        spikes, vs = [], []
        for t in range(i_exc_t.shape[0]):
            neuron, out = adex.step(neuron, i_exc_t[t], i_inh_t[t], params,
                                    cfg.dt, adex=cfg.neuron.adex,
                                    decays=self.decays)
            rate_counters = rate_counters + out
            spikes.append(out)
            if record_v:
                vs.append(neuron.v)
        recs = (torch.stack(spikes),)
        if record_v:
            recs = (recs[0], torch.stack(vs))
        return neuron, rate_counters, recs

    def _run_windowed(self, state: AnnCoreState, row_spikes_t, row_addr_t,
                      record_v: bool = False, telemetry=None):
        """Window currents (phases 1+2) -> neuron window (phase 3) ->
        output-driver fault hooks -> correlation window (phase 4: the
        sensors never feed back into the dynamics within a window)."""
        cfg = self.cfg
        new_stp, i_exc_t, i_inh_t, telemetry = self._window_currents(
            state, row_spikes_t, row_addr_t, telemetry)
        new_neuron, rate_counters, recs = self._neuron_window(
            state.neuron, state.rate_counters, i_exc_t, i_inh_t, record_v)
        out_spikes_t = recs[0]
        if self.faults is not None:
            out_spikes_t = finject.spikes(self.faults, out_spikes_t)
            rate_counters = finject.rates(self.faults, rate_counters,
                                          state.rate_counters,
                                          row_spikes_t.shape[0])
        new_corr = correlation.window(
            state.corr, row_spikes_t, out_spikes_t,
            tau_pre=cfg.neuron.tau_syn_exc, tau_post=cfg.neuron.tau_syn_exc,
            dt=cfg.dt)
        new_state = AnnCoreState(neuron=new_neuron, stp=new_stp,
                                 corr=new_corr, syn=state.syn,
                                 rate_counters=rate_counters)
        out = dict(spikes=out_spikes_t)
        if record_v:
            out["v"] = recs[1]
        if telemetry is not None:
            out["telemetry"] = obs_trace.count_run(telemetry, row_spikes_t,
                                                   out_spikes_t)
        return new_state, out
