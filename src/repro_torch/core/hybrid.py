"""Hybrid plasticity: the §5 closed-loop experiment (paper §2.2, §5).

The learning rule runs on the machine: the PPU reads rate counters and
correlation sensors, joins them with the reward and writes 6-bit weights,
with no host round trip. The experiment is §5's pattern-discrimination
task: inputs with Poisson background, patterns A/B on overlapping
channels; even neurons are rewarded for firing on A, odd ones on B.

Like the reference's ``scanned_training``, a run draws every trial's
events (and the exploration noise) in one batch before the first trial.
The draws come from a ``torch.Generator``, or are injected (``Draws``):
``repro_torch.convert`` replays the reference's ``jax.random`` key chain
so both packages see the same numbers. ``run_training`` has the
reference's three modes (``repro/core/hybrid.py:521-620``):

- ``fused=True, scan=True`` (the default): the whole experiment as one
  device dispatch. On a CUDA device one trial is captured as a CUDA graph
  (``TrialGraph``) that reads its stimulus and draws from device-resident
  tensors at a step counter it advances itself, and the graph is replayed
  once a trial: the host does one ``replay()`` a trial. On the CPU, which
  has no graphs, the same trial body (``TrialLoop``) runs trial by trial.
- ``fused=True, scan=False``: a Python loop of eager trials.
- ``fused=False``: the host-in-the-loop baseline (``host_loop_trial``).

All three give the same histories and final state bit for bit. The rule
runs as Python tensor code (``rule_impl="python"``) or as a PPU-VM program
(``rule_impl="vm"``, the ``ppuvm_exec`` kernel on the card).

The verification layer threads through it as in the reference
(``repro/core/hybrid.py:272-309, 403-441, 608-609``): ``telemetry=True``
carries an ``obs.trace.Telemetry`` in the state (``ExperimentState
.tele``) that every trial adds to, replay or not, and ``run_training``
returns its summary; ``faults=`` injects a ``FaultPlan`` overlay and
``blacklist=`` a screened ``Blacklist`` on top of it (``chain(faults,
blacklist.as_faults(...))``, injection first).

``wafer=K`` partitions the experiment over K virtual chips
(``repro/core/hybrid.py:215-236, 246-262, 322-366, 403-411``): the
neuron columns split into K contiguous blocks, one a chip (the instance
prefix becomes ``(K,)``), every chip sees all 2I input rows, and an
``InterChipRouter`` closes the trial loop: each trial's spikes cross the
bus and arrive as relay-row events in the next trial (``ExperimentState
.routed`` carries them). The instance and the draws are made for the
whole network and then placed on the chips (``wafer_instance``,
``wafer_draws``), so the run is the same bit for bit on every chip
count. A blacklist with links reroutes the plan around them
(``wafer.reroute_plan``; forwarded traffic counts in ``link_reroutes``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.bss2 import BSS2, BSS2Config
from repro_torch.core import synapse
from repro_torch.core.anncore import AnnCore, AnnCoreState
from repro_torch.core.graph import (LoopGraph, assign, clones,
                                    leaves as _leaves, rebuild as _rebuild)
from repro_torch.core.ppu import VectorUnit
from repro_torch.faults.model import (as_plans, chain, remap_link_faults,
                                      slice_chips)
from repro_torch.obs import trace as obs_trace
from repro_torch.ppuvm import isa, programs
from repro_torch.verif.mismatch import sample_instance
from repro_torch.wafer import InterChipRouter, reroute_plan, s5_column_plan


@dataclass(frozen=True)
class RSTDPConfig:
    n_inputs: int = 16
    n_neurons: int = 16
    pattern_size: int = 5
    overlap: float = 0.4          # fraction of shared channels (paper: 40%)
    trial_steps: int = 256        # dt steps per trial
    bg_prob: float = 0.008        # background spike prob / channel / dt
    pattern_repeats: int = 4      # pattern burst repetitions per trial
    eta: float = 16.0
    eta_homeo: float = 0.4        # escape term only, well below the
                                  # eligibility term
    gamma: float = 0.3            # paper Eq. 2
    noise: float = 0.1            # random-walk xi
    w_init: float = 20.0
    burst_width: int = 2          # consecutive dt steps per pattern burst
    fire_thresh: float = 1.0      # spikes to count as "fired"


class ExperimentState(NamedTuple):
    """The reference's ``ExperimentState`` without the PRNG key (draws
    come from a generator or are injected)."""
    core: AnnCoreState
    w_signed: torch.Tensor        # PPU-resident signed weights [.., I, C]
    mean_reward: torch.Tensor     # [.., C]
    tele: Any = None              # obs.trace.Telemetry (None = off)
    routed: Any = None            # wafer mode: [T, K, R] inter-chip events
    #                               the last trial deposited for this one
    #                               (None = single chip)


class Draws(NamedTuple):
    """Every random number a run consumes after the instance."""
    events: torch.Tensor          # [n_trials, T, *prefix, 2I] float32 {0,1}
    xi: torch.Tensor              # [n_trials, *prefix, I, C] float32


def _patterns(ecfg: RSTDPConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Channel sets for patterns A and B with the requested overlap."""
    k = ecfg.pattern_size
    n_shared = int(round(ecfg.overlap * k))
    a = list(range(k))
    b = a[:n_shared] + list(range(k, 2 * k - n_shared))
    mask_a = np.zeros(ecfg.n_inputs, np.float32)
    mask_b = np.zeros(ecfg.n_inputs, np.float32)
    mask_a[a] = 1
    mask_b[b] = 1
    return mask_a, mask_b


def _burst_schedule(ecfg: RSTDPConfig) -> np.ndarray:
    """[T] float32: 1 on the dt steps of a pattern burst."""
    T = ecfg.trial_steps
    times = np.linspace(T // 8, T - T // 8, ecfg.pattern_repeats,
                        dtype=np.float32).astype(np.int64)
    d = np.arange(T)[:, None] - times[None, :]
    return np.any((d >= 0) & (d < ecfg.burst_width), axis=1
                  ).astype(np.float32)


def wafer_instance(inst: Dict, K: int) -> Dict:
    """The instance of the whole network ([n_neurons] columns, [2I] rows,
    no prefix) placed on K chips (``repro/core/hybrid.py:253-262``): the
    column parameters split into K contiguous blocks ``(K, n_neurons /
    K)``, the row parameters (the STP drivers) copied to every chip
    ``(K, 2I)``."""
    def cols(x):
        return x.reshape(K, -1)

    def rows(x):
        return x.reshape(1, -1).repeat(K, 1)
    return dict(
        neuron_params={k: cols(v) for k, v in inst["neuron_params"].items()},
        weight_gain=cols(inst["weight_gain"]),
        stp_offset=rows(inst["stp_offset"]),
        stp_calib=rows(inst["stp_calib"]),
        cadc_offset=cols(inst["cadc_offset"]),
        cadc_gain=cols(inst["cadc_gain"]))


def wafer_draws(draws: Draws, K: int) -> Draws:
    """Draws of the whole network (events [n, T, 2I], xi [n, I,
    n_neurons]) placed on K chips (``repro/core/hybrid.py:350-366``): the
    stimulus copied to every chip [n, T, K, 2I], xi's columns split into
    K blocks [n, K, I, n_neurons / K]."""
    n, I = draws.xi.shape[0], draws.xi.shape[1]
    ev = draws.events
    return Draws(events=ev.unsqueeze(2).expand(*ev.shape[:2], K,
                                               ev.shape[-1]).contiguous(),
                 xi=draws.xi.reshape(n, I, K, -1).transpose(1, 2)
                 .contiguous())


def column_instance(inst: Dict, parts: int, part: int) -> Dict:
    """The instance of a whole chip ([*prefix, C] column parameters,
    [*prefix, 2I] row parameters) cut to the ``part``-th of ``parts``
    contiguous column blocks, the prefix kept (``wafer_instance`` takes the
    same blocks of an instance without a prefix): the column parameters
    sliced, the row parameters (the STP drivers) whole."""
    def cols(x):
        c = x.shape[-1] // parts
        return x[..., part * c:(part + 1) * c].contiguous()
    return dict(
        neuron_params={k: cols(v) for k, v in inst["neuron_params"].items()},
        weight_gain=cols(inst["weight_gain"]),
        stp_offset=inst["stp_offset"], stp_calib=inst["stp_calib"],
        cadc_offset=cols(inst["cadc_offset"]),
        cadc_gain=cols(inst["cadc_gain"]))


def column_draws(draws: Draws, parts: int, part: int) -> Draws:
    """A whole chip's draws (xi [n, *prefix, I, C]) cut to the
    ``part``-th of ``parts`` contiguous column blocks, as ``wafer_draws``
    splits xi: xi's columns sliced, the events (rows) whole."""
    c = draws.xi.shape[-1] // parts
    return Draws(events=draws.events,
                 xi=draws.xi[..., part * c:(part + 1) * c].contiguous())


def draw_trials(gen: torch.Generator, stims, ecfg: RSTDPConfig,
                prefix=()) -> Draws:
    """Every trial's events and exploration noise for ``stims`` in one
    batch, on the generator's device: background events [n, T, *prefix,
    I] under the stimuli's bursts (``events_from_background``), then xi
    [n, *prefix, I, C]."""
    n, T, I = len(stims), ecfg.trial_steps, ecfg.n_inputs
    u = torch.rand((n, T, *prefix, I), generator=gen, device=gen.device)
    bg = (u < ecfg.bg_prob).to(torch.float32)
    xi = ecfg.noise * torch.randn((n, *prefix, I, ecfg.n_neurons),
                                  generator=gen, device=gen.device)
    return Draws(events=events_from_background(bg, stims, ecfg), xi=xi)


def events_from_background(bg, stims, ecfg: RSTDPConfig):
    """Event grids [n, T, *prefix, 2I] from background spikes
    [n, T, *prefix, I] and stimuli [n] in {0: none, 1: A, 2: B}: bursts
    on the pattern channels, clipped to {0, 1}, and input i driving rows
    2i (exc) and 2i+1 (inh) with the same events."""
    mask_a, mask_b = _patterns(ecfg)
    pats = np.stack([np.zeros_like(mask_a), mask_a, mask_b])
    pat_mask = torch.as_tensor(pats[np.asarray(stims)], device=bg.device)
    is_burst = torch.as_tensor(_burst_schedule(ecfg), device=bg.device)
    n_prefix = bg.ndim - 3
    pat = (is_burst.reshape(1, -1, *([1] * n_prefix), 1)
           * pat_mask.reshape(-1, 1, *([1] * n_prefix), ecfg.n_inputs))
    ch = torch.clamp(bg + pat, 0, 1)
    return ch.repeat_interleave(2, dim=-1)


def make_experiment(cfg: BSS2Config = None, ecfg: RSTDPConfig = RSTDPConfig(),
                    inst: Dict = None, generator: torch.Generator = None,
                    prefix=(), backend: str = "auto",
                    sparse_mode: str = None, rule_impl: str = "python",
                    device=None, telemetry: bool = False, faults=None,
                    blacklist=None, wafer: int = None,
                    wafer_topology: str = "all2all", wafer_relay: bool = True,
                    wafer_plan=None, group=None, link_budget: int = None,
                    link_mode: str = "auto"):
    """Build the experiment. Returns ``(init, trial, meta)``.

    The machine uses 2 rows per input (exc/inh pair, Dale's law: the PPU
    writes |w| to the row matching the sign — paper §5).

    Args:
      cfg: chip geometry; ``None`` derives the reduced §5 geometry
        (``2*n_inputs`` rows x ``n_neurons`` cols) from ``ecfg``.
      ecfg: the §5 experiment parameters.
      inst: an injected virtual instance (e.g. the reference's, through
        ``repro_torch.convert.instance``); ``None`` samples one from
        ``generator`` (default: a CPU generator seeded with 7). In wafer
        mode it is the instance of the whole network, placed on the chips
        here (``wafer_instance``; ``meta["inst"]`` holds the placed one).
      prefix: instance prefix of a fleet of independent chips; ``()`` in
        wafer mode, which owns the prefix.
      backend: AnnCore backend ("auto" | "oracle" | "fused" | "blocked").
      sparse_mode: the event-sparse synaptic route ("auto" | "never" |
        "always", see ``synapse.synaptic_current_window``); ``None``
        keeps AnnCore's "auto" (at full width the census gate picks the
        route of every window).
      rule_impl: how the learning rule runs. "python": ``_signed_rule``
        in tensor ops. "vm": its vector part as the PPU-VM program
        ``ppuvm.programs.signed_dw_program`` (put on the device once,
        here), whose register 0 is the per-row dw; the scalar glue (Eq. 2,
        the xi walk, the Dale row rewrite) is the python rule's, so the
        two differ only by the Q8.8 rounding of dw.
      device: where the experiment runs; ``None`` means ``cuda`` and
        raises without a card.
      telemetry: carry an ``obs.trace.Telemetry`` in the state
        (``ExperimentState.tele``): spike and event totals, the route
        gate's decisions and overflow fallbacks, VM saturation-rail hits,
        the weight-update histogram and the fault gauges. Off (default)
        the slot is ``None`` and the trial launches what it did before;
        on/off histories are bit-identical.
      faults: a ``repro_torch.faults.FaultPlan`` (or sequence) injected
        into the emulated silicon (``None`` is the identity).
      blacklist: a ``repro_torch.faults.Blacklist`` (from
        ``faults.screen``) applied on top of the faults as the
        graceful-degradation reduction; its links (wafer mode only)
        reroute the plan over an intermediate chip
        (``wafer.reroute_plan``), carrying the plan's link faults over to
        the new link order when a ring is promoted to all2all.
      wafer: chip count K (``None``: one chip).
      wafer_topology: "all2all" | "ring", the link graph of the built-in
        §5 split (``wafer.s5_column_plan``).
      wafer_relay: announce every neuron's spikes to every chip over the
        bus (relay rows carrying address 63; needs "all2all").
      wafer_plan: an explicit ``WaferPlan`` in place of the built-in
        split, with the per-chip geometry ``(2 n_inputs, n_neurons / K)``.
      group: a ``torch.distributed`` process group of ``dp`` ranks
        (wafer mode only): the sharded transport of
        ``wafer.InterChipRouter(group=)``. Each rank holds chips ``[rank
        K / dp, (rank + 1) K / dp)``: its core, vector unit, state and
        draws are those chips' (``meta["chips"]``), the router every
        link fault by its absolute id, and the run equals the local
        transport's slice bit for bit. Telemetry's core counters count
        the rank's own chips; the link counters are summed over the group.
      link_budget / link_mode: the router's bus budget and transport
        (``wafer.InterChipRouter``).

    ``trial(state, stim, events, xi)`` runs one trial with its draws
    (``stim`` an int or a 0-d int32 tensor on the device);
    ``meta["train"](state, stims, draws)`` runs a batch of them from a
    Python loop, ``meta["scanned_training"](state, stims, draws)`` runs the
    same batch as one device dispatch (see ``make_scanned_training``), and
    ``meta["draw"](generator, stims)`` draws them (in wafer mode for the
    whole network, then placed on the chips; under a ``group``, this
    rank's chips of them).
    """
    device = resolve_device(device)
    if rule_impl not in ("python", "vm"):
        raise ValueError(f"unknown rule_impl {rule_impl!r}")
    if cfg is None:
        cfg = dataclasses.replace(
            BSS2.reduced(), n_rows=2 * ecfg.n_inputs, n_cols=ecfg.n_neurons)
    if cfg.n_rows != 2 * ecfg.n_inputs or cfg.n_cols != ecfg.n_neurons:
        raise ValueError("the §5 wiring needs n_rows == 2*n_inputs and "
                         "n_cols == n_neurons")
    prefix = tuple(prefix)
    I, C, T = ecfg.n_inputs, ecfg.n_neurons, ecfg.trial_steps
    K = wafer
    chip_cfg, plan = cfg, None
    if group is not None and not K:
        raise ValueError("a group shards the chips of a wafer run: pass "
                         "wafer=K with it")
    if K:
        if prefix != ():
            raise ValueError("wafer mode owns the instance prefix")
        if C % K or (C // K) % 2:
            raise ValueError("wafer mode needs an even per-chip column "
                             "count (reward parity)")
        chip_cfg = dataclasses.replace(cfg, n_cols=C // K)
        if wafer_plan is not None:
            plan = wafer_plan
            if plan.topology.n_chips != K or (plan.n_rows, plan.n_cols) != (
                    2 * I, C // K):
                raise ValueError(
                    f"wafer_plan is for {plan.topology.n_chips} chips of "
                    f"{(plan.n_rows, plan.n_cols)}, the experiment needs {K} "
                    f"of {(2 * I, C // K)}")
        else:
            plan = s5_column_plan(K, I, C, relay=wafer_relay,
                                  kind=wafer_topology)
    c_loc = chip_cfg.n_cols
    mask_a, mask_b = _patterns(ecfg)
    even = (torch.arange(C, device=device) % 2 == 0).to(torch.float32)
    if K:
        even = even.reshape(K, c_loc)
    odd, nobody = 1.0 - even, torch.zeros_like(even)
    # the stimuli as 0-d device tensors, made once: a trial given an int
    # takes one of these, so it builds nothing from host data
    stim_of = {k: torch.tensor(k, dtype=torch.int32, device=device)
               for k in (0, 1, 2)}
    if inst is None:
        if generator is None:
            generator = torch.Generator().manual_seed(7)
        inst = sample_instance(cfg, generator, () if K else prefix,
                               device=device)
    if K:
        # one instance of the whole network, placed on the chips
        inst = wafer_instance(inst, K)
        prefix = (K,)
    # fault overlay: injection plans first, the blacklist reduction last
    # (its masks dominate the faults they cover: the exactness contract)
    overlay = faults
    if blacklist is not None and blacklist.total:
        overlay = chain(faults, blacklist.as_faults(inst, cfg.cadc_bits)
                        if blacklist.n_rows or blacklist.n_neurons else None)
        if blacklist.links:
            if not K:
                raise ValueError("link blacklists need wafer mode")
            old_links = plan.topology.links()
            plan, _ = reroute_plan(plan, blacklist.links)
            new_links = plan.topology.links()
            if new_links != old_links:
                # a ring promoted to all2all re-indexed the links: carry
                # the injected link faults over by chip pair
                overlay = tuple(remap_link_faults(p, old_links, new_links)
                                for p in as_plans(overlay))
    router = None if not K else InterChipRouter(
        plan, device=device, link_budget=link_budget, link_mode=link_mode,
        faults=overlay, group=group)
    chips = slice(None)
    if router is not None and router.dp > 1:
        # this rank's chips: its block of the placed instance, the reward
        # parity and the core's fault planes (the router keeps them all)
        chips = router._chips
        inst = {k: ({n: v[chips] for n, v in x.items()}
                    if k == "neuron_params" else x[chips])
                for k, x in inst.items()}
        even = even[chips]
        odd, nobody = odd[chips], nobody[chips]
        overlay = slice_chips(overlay, chips)
        prefix = (router.K_loc,)
    # const_addr: every driver row carries exactly one source here (input
    # i -> rows 2i/2i+1, address 0 throughout). In wafer mode the relay
    # rows break that promise where a relayed event lands: the dense route
    # then takes each row's address at step 0, as the reference's does
    # (``repro/core/synapse.py:79-80``)
    core_kw = {} if sparse_mode is None else dict(sparse_mode=sparse_mode)
    core = AnnCore(chip_cfg, inst, backend=backend, const_addr=True,
                   faults=overlay, **core_kw)
    ppu = VectorUnit(chip_cfg, inst, faults=overlay)
    addr = torch.zeros((T, *prefix, 2 * I), dtype=torch.int8, device=device)
    if rule_impl == "vm":
        dw_words = torch.as_tensor(programs.signed_dw_program(
            eta=ecfg.eta, eta_homeo=ecfg.eta_homeo,
            fire_thresh=ecfg.fire_thresh), device=device)

    def _write_signed(syn, w_signed):
        """interleave exc/inh rows: row 2i exc, 2i+1 inh"""
        w_exc = torch.clamp(w_signed, min=0)
        w_inh = torch.clamp(-w_signed, min=0)
        w_rows = torch.stack([w_exc, w_inh], dim=-2)   # [.., I, 2, C]
        w_rows = w_rows.reshape(*w_signed.shape[:-2], 2 * I, c_loc)
        return syn._replace(weights=synapse.quantize_weight(w_rows))

    def init() -> ExperimentState:
        st = core.init_state(prefix)
        w0 = ecfg.w_init * torch.ones((*prefix, I, c_loc), device=device)
        st = st._replace(syn=_write_signed(st.syn, w0))
        return ExperimentState(
            core=st, w_signed=w0,
            mean_reward=torch.zeros((*prefix, c_loc), device=device),
            tele=obs_trace.init_telemetry(device) if telemetry else None,
            routed=router.init_buffer(T) if router is not None else None)

    def _reward(rates, stim):
        """The reference's ``where`` form (``repro/core/hybrid.py:368-
        373``) on a 0-d int32 ``stim``: no branch on the host."""
        fired = (rates >= ecfg.fire_thresh).to(torch.float32)
        own_shown = torch.where(stim == 1, even,
                                torch.where(stim == 2, odd, nobody))
        return torch.where(own_shown > 0, fired, 1.0 - fired)

    def _signed_rule(w_rows, obs, rule_state, *, reward):
        """R-STDP on the signed input-level weights; rewrite both rows."""
        causal = obs["causal"][..., 0::2, :]       # exc rows carry the
        acausal = obs["acausal"][..., 0::2, :]     # pre-spike correlations
        elig = (causal - acausal).to(torch.float32) / 255.0
        mod = (reward - rule_state["mean_reward"]).unsqueeze(-2)
        dw = ecfg.eta * mod * elig
        # homeostatic term (PPU rate counters): fired & unrewarded ->
        # uniform depression; silent & unrewarded -> uniform potentiation
        fired = (obs["rates"] >= ecfg.fire_thresh).to(torch.float32)
        dw = dw + ecfg.eta_homeo * (
            (1.0 - reward) * (1.0 - 2.0 * fired)).unsqueeze(-2)
        w_signed = rule_state["w_signed"] + dw + rule_state["xi"]
        w_signed = torch.clamp(w_signed, -45.0, 45.0)
        mean_r = rule_state["mean_reward"] + ecfg.gamma * (
            reward - rule_state["mean_reward"])                 # Eq. 2
        new_syn = _write_signed(
            synapse.SynapseArray(w_rows.to(torch.int8),
                                 torch.zeros_like(w_rows,
                                                  dtype=torch.int8)),
            w_signed)
        return new_syn.weights.to(torch.float32), dict(
            mean_reward=mean_r, w_signed=w_signed)

    def _vm_signed_update(cs, state, reward, xi, tele):
        """The §5 rule with its vector part as a PPU-VM program: register
        0 holds the per-row dw; the scalar core applies it to the signed
        float weights, adds the xi walk and rewrites both Dale rows, as
        ``_signed_rule`` does (``repro/core/hybrid.py:383-398``)."""
        qc, qa = ppu.read_correlation(cs.corr)
        mod = torch.stack([reward - state.mean_reward, reward])
        cs2, regs = ppu.run_program(cs, dw_words, mod=mod)
        tele = obs_trace.count_vm(tele, regs)
        dw = regs[0][..., 0::2, :].to(torch.float32) / isa.ONE
        w_signed = torch.clamp(state.w_signed + dw + xi, -45.0, 45.0)
        mean_r = state.mean_reward + ecfg.gamma * (
            reward - state.mean_reward)                         # Eq. 2
        cs2 = cs2._replace(syn=_write_signed(cs2.syn, w_signed))
        return (cs2, dict(mean_reward=mean_r, w_signed=w_signed),
                dict(causal=qc, acausal=qa), tele)

    def trial(state: ExperimentState, stim, events, xi):
        """One training trial: emulate the window, reward, PPU update.
        ``stim`` in {0: none, 1: A, 2: B}, an int or a 0-d int32 tensor on
        the device; ``events`` [T, *prefix, 2I]; ``xi`` [*prefix, I, C]."""
        if not isinstance(stim, torch.Tensor):
            if int(stim) not in stim_of:
                raise ValueError(f"stim must be 0, 1 or 2, got {stim}")
            stim = stim_of[int(stim)]
        if router is not None:
            # close the wafer loop: last trial's routed spikes merge into
            # this trial's inputs, this trial's spikes go on the bus
            cs, core_out = core.run_routed(state.core, state.routed, events,
                                           addr, router, telemetry=state.tele)
        else:
            cs, core_out = core.run(state.core, events, addr,
                                    telemetry=state.tele)
        tele = core_out.get("telemetry")
        rates = cs.rate_counters
        r = _reward(rates, stim)
        tele = obs_trace.count_trial(tele, rates)
        if rule_impl == "vm":
            cs2, rule_state, obs, tele = _vm_signed_update(cs, state, r, xi,
                                                           tele)
        else:
            cs2, rule_state, obs = ppu.apply_rule(
                _signed_rule, cs,
                dict(mean_reward=state.mean_reward,
                     w_signed=state.w_signed, xi=xi),
                reward=r)
        tele = obs_trace.count_dw(tele, state.w_signed,
                                  rule_state["w_signed"])
        new = ExperimentState(core=cs2, w_signed=rule_state["w_signed"],
                              mean_reward=rule_state["mean_reward"],
                              tele=tele, routed=core_out.get("routed"))
        elig = (obs["causal"][..., 0::2, :]
                - obs["acausal"][..., 0::2, :]).to(torch.float32) / 255.0
        metrics = dict(reward=r, mean_reward=rule_state["mean_reward"],
                       rates=rates, elig=elig, w=rule_state["w_signed"])
        return new, metrics

    def draw(gen: torch.Generator, stims) -> Draws:
        """Every trial's events and exploration noise in one batch, drawn
        on the generator's device and moved to the experiment's; in wafer
        mode drawn for the whole network and placed on the chips."""
        d = draw_trials(gen, stims, ecfg, () if K else prefix)
        if K:
            d = wafer_draws(d, K)
            d = Draws(events=d.events[:, :, chips], xi=d.xi[:, chips])
        return Draws(events=d.events.to(device), xi=d.xi.to(device))

    def train(state: ExperimentState, stims, draws: Draws):
        """Run ``len(stims)`` trials; metrics stacked [n_trials, ...] on
        the device."""
        hist = []
        for i, stim in enumerate(stims):
            state, m = trial(state, stim, draws.events[i], draws.xi[i])
            hist.append(m)
        out = {k: torch.stack([h[k] for h in hist]) for k in hist[0]}
        out["stim"] = torch.as_tensor(stims, dtype=torch.int32)
        return state, out

    def scanned_training(state: ExperimentState, stims, draws: Draws):
        """Run ``len(stims)`` trials as ``TrialLoop``'s body: on a CUDA
        device one captured ``TrialGraph`` replayed once a trial, on the
        CPU the body trial by trial. Returns ``(state, hist)`` as ``train``
        does, bit for bit. A later call with as many trials and draws of
        the same shapes loads its state and draws into the same loop and
        replays the same graph (``scanned_training.loops``), as the
        reference's jitted function runs without a retrace."""
        key = (len(stims), tuple(draws.events.shape), tuple(draws.xi.shape))
        if key in loops:
            loop, run = loops[key]
            loop.load(state, stims, draws)
        else:
            loop = TrialLoop(trial, state, stims, draws)
            run = (TrialGraph(loop).replay if device.type == "cuda"
                   else loop.body)
            loops[key] = loop, run
        for _ in range(loop.n):
            run()
        return (clones(loop.state),
                {k: v.clone() for k, v in loop.history().items()})

    loops = scanned_training.loops = {}

    meta = dict(cfg=cfg, ecfg=ecfg, inst=inst, core=core, ppu=ppu,
                mask_a=mask_a, mask_b=mask_b, even=even, train=train,
                draw=draw, scanned_training=scanned_training, router=router,
                chips=chips)
    return init, trial, meta


def column_part(cfg: BSS2Config, ecfg: RSTDPConfig, parts: int, part: int,
                inst: Dict = None, generator: torch.Generator = None,
                prefix=(), backend: str = "auto", device=None):
    """Columns ``[part c, (part + 1) c)``, ``c = C / parts``, of the
    experiment ``ecfg`` on the chip ``cfg`` (C = ``cfg.n_cols``): one
    rank's part of a chip whose synapse columns are split over ``parts``
    ranks (the reference's ``lower_bss2_cell`` shards them over
    ``model``). Returns ``(init, trial, meta)`` of ``make_experiment`` on a
    chip of ``c`` columns, with

    - the part's slice of the whole chip's instance (``inst``, or sampled
      for the whole chip from ``generator``; ``column_instance``), the
      row parameters whole;
    - each window's route planned from the whole chip's columns
      (``AnnCore.plan_cols``): a part takes the whole chip's routes,
      capacities and kernel launches (the census, a row quantity, is the
      same on every part);
    - ``meta["draw"]`` drawing the whole chip's trials and returning the
      part's columns of them (``column_draws``; injected draws are cut the
      same way), and ``meta["cols"]`` the part's slice of the columns.

    Nothing in a trial couples the columns: the STP scan, its census and
    the events act on rows, which every part holds whole, and the neuron
    scan, the sensors, the reward, Eq. 2's mean reward, the CADC read and
    the rule act column by column. So the parts need no collective, and
    the parts gathered are the whole chip's trial bit for bit. ``c`` must
    be even: the reward's parity, as in wafer mode."""
    C = cfg.n_cols
    if parts < 1 or C % parts or (C // parts) % 2:
        raise ValueError(f"{C} columns in {parts} parts: each part needs an "
                         f"even column count (reward parity)")
    if not 0 <= part < parts:
        raise ValueError(f"part {part} of {parts}")
    device = resolve_device(device)
    prefix = tuple(prefix)
    if inst is None:
        if generator is None:
            generator = torch.Generator().manual_seed(7)
        inst = sample_instance(cfg, generator, prefix, device=device)
    c = C // parts
    init, trial, meta = make_experiment(
        cfg=dataclasses.replace(cfg, n_cols=c),
        ecfg=dataclasses.replace(ecfg, n_neurons=c),
        inst=column_instance(inst, parts, part), prefix=prefix,
        backend=backend, device=device)
    meta["core"].plan_cols = C

    def draw(gen: torch.Generator, stims) -> Draws:
        d = column_draws(draw_trials(gen, stims, ecfg, prefix), parts, part)
        return Draws(events=d.events.to(device), xi=d.xi.to(device))
    meta.update(draw=draw, cols=slice(part * c, (part + 1) * c))
    return init, trial, meta


class TrialLoop:
    """The experiment as a loop of one body with no host work in it.

    ``body()`` runs the trial at the loop's step counter, a tensor on the
    device: it reads that trial's stimulus, events and xi from the
    device-resident ``stims`` and ``draws``, writes the trial's metrics into
    ``[n_trials, ...]`` histories at the counter, copies the new state into
    the loop's own state tensors (``state``, cloned from the given state)
    and advances the counter. Nothing in it reads the host or builds a
    tensor from host data, so a CUDA graph can capture it (``TrialGraph``).
    The histories are allocated by the first ``body()`` (from its metrics'
    shapes)."""

    def __init__(self, trial, state: ExperimentState, stims, draws: Draws):
        dev = state.w_signed.device
        self.trial = trial
        self.initial = state
        self.state = clones(state)
        self.stims = torch.as_tensor(stims, dtype=torch.int32).to(dev)
        self.n = self.stims.shape[0]
        if self.n == 0:
            raise ValueError("TrialLoop: no trials to run")
        if draws.events.shape[0] < self.n or draws.xi.shape[0] < self.n:
            raise ValueError(f"TrialLoop: draws for {draws.events.shape[0]} "
                             f"trials, {self.n} stimuli")
        # the loop's own copies: ``load`` writes a later run's draws here
        self.events = draws.events.to(dev, copy=True)
        self.xi = draws.xi.to(dev, copy=True)
        self.step = torch.zeros(1, dtype=torch.int64, device=dev)
        self.hist = None

    def body(self):
        i = self.step
        new, m = self.trial(self.state,
                            self.stims.index_select(0, i).reshape(()),
                            self.events.index_select(0, i)[0],
                            self.xi.index_select(0, i)[0])
        if self.hist is None:
            self.hist = {k: v.new_empty((self.n, *v.shape))
                         for k, v in m.items()}
        for k, v in m.items():
            self.hist[k].index_copy_(0, i, v.unsqueeze(0))
        self._assign(new)
        self.step += 1

    def _assign(self, new: ExperimentState):
        """Copy ``new`` into the loop's state tensors (``graph.assign``)."""
        assign(_leaves(self.state), _leaves(new), "TrialLoop")

    def reset(self):
        """The state back to the given state, the counter to 0."""
        for d, s in zip(_leaves(self.state), _leaves(self.initial)):
            d.copy_(s)
        self.step.zero_()

    def load(self, state: ExperimentState, stims, draws: Draws):
        """Another run of as many trials through the same tensors: ``state``
        becomes the given state, ``stims`` and ``draws`` (the same shapes)
        are copied into the loop's, and the loop is reset."""
        if len(_leaves(state)) != len(_leaves(self.state)):
            raise ValueError("TrialLoop.load: the state has other fields")
        self.initial = state
        self.stims.copy_(torch.as_tensor(stims, dtype=torch.int32))
        self.events.copy_(draws.events)
        self.xi.copy_(draws.xi)
        self.reset()

    def history(self):
        """The metrics stacked [n_trials, ...] and the stimuli."""
        return dict(self.hist, stim=self.stims)


# ``TrialLoop.body`` captured once as a CUDA graph; ``replay()`` runs the
# next trial (the capture code is ``graph.LoopGraph``, shared with the
# mapped runtime's window loop)
TrialGraph = LoopGraph


def make_scanned_training(meta):
    """The whole experiment as one device dispatch (the reference's
    ``make_scanned_training``, ``repro/core/hybrid.py:512-518``):
    ``scanned(state, stims, draws) -> (state, hist)``, which is
    ``meta["scanned_training"]``. On a CUDA device it captures one trial
    (``TrialGraph``) and replays it once a trial; a capture that fails
    raises. On the CPU, which has no graphs, it runs the same trial body
    trial by trial. (The reference jits here; eager PyTorch has nothing
    to compile: the capture happens at the first call of a shape, and
    later calls replay it.)"""
    return meta["scanned_training"]


def stimuli(n_trials: int) -> np.ndarray:
    """The stimulus sequence of ``run_training``: A, B, none, A, ..."""
    return np.resize(np.asarray([1, 2, 0], np.int32), n_trials)


def run_training(n_trials: int = 300, ecfg: RSTDPConfig = RSTDPConfig(),
                 seed: int = 0, cfg: BSS2Config = None, fused: bool = True,
                 scan: bool = None, backend: str = "auto",
                 sparse_mode: str = None, rule_impl: str = "python",
                 device=None, inst: Dict = None, draws: Draws = None,
                 telemetry: bool = False, faults=None, blacklist=None,
                 wafer: int = None, wafer_topology: str = "all2all",
                 wafer_relay: bool = True, wafer_plan=None, group=None,
                 link_budget: int = None, link_mode: str = "auto"):
    """Full §5 experiment. Returns ``(out, state, meta)``: ``out`` the
    metrics history as numpy arrays stacked [n_trials, ...] plus
    ``w_signed_final`` (and, with ``telemetry=True``, the counters'
    ``obs.trace.summary`` under ``"telemetry"``); ``state`` the final
    ``ExperimentState``. ``telemetry`` / ``faults`` / ``blacklist`` and the
    wafer keywords (``wafer``, ``wafer_topology``, ``wafer_relay``,
    ``wafer_plan``, ``group``, ``link_budget``, ``link_mode``) go to
    ``make_experiment``. Under a ``group`` each rank runs and returns its
    own chips (``meta["chips"]``), and injected ``draws`` are the rank's
    own chips' as ``meta["draw"]`` gives them.

    Modes, as the reference's (``scan=None`` means ``scan=fused``):
      fused=True, scan=True   one device dispatch: ``make_scanned_training``
                              (a captured trial graph replayed on the card)
      fused=True, scan=False  a Python loop of eager trials (``train``)
      fused=False             host-in-the-loop: ``host_loop_trial``
    All three give the same results bit for bit.

    ``seed`` seeds the instance generator (``seed``) and the run's draws
    (``seed + 1``), both CPU ``torch.Generator``s, so a seed gives the same
    run on every device. ``inst`` / ``draws`` inject the reference's
    instance and draws instead (``repro_torch.convert``; in wafer mode the
    whole network's instance and the placed draws, ``wafer_draws``).
    ``device``:
    ``None`` means ``cuda`` and raises without a card.
    """
    device = resolve_device(device)
    init, trial, meta = make_experiment(
        cfg=cfg, ecfg=ecfg, inst=inst,
        generator=torch.Generator().manual_seed(seed), backend=backend,
        sparse_mode=sparse_mode, rule_impl=rule_impl, device=device,
        telemetry=telemetry, faults=faults, blacklist=blacklist, wafer=wafer,
        wafer_topology=wafer_topology, wafer_relay=wafer_relay,
        wafer_plan=wafer_plan, group=group, link_budget=link_budget,
        link_mode=link_mode)
    stims = stimuli(n_trials)
    if draws is None:
        draws = meta["draw"](torch.Generator().manual_seed(seed + 1), stims)
    if scan is None:
        scan = fused
    state = init()
    if fused and scan:
        state, hist = make_scanned_training(meta)(state, stims, draws)
    elif fused:
        state, hist = meta["train"](state, stims, draws)
    else:
        hist = []
        for i, stim in enumerate(stims):
            state, m = host_loop_trial(trial, state, stim, draws.events[i],
                                       draws.xi[i])
            hist.append(m)
        hist = {k: torch.stack([h[k] for h in hist]) for k in hist[0]}
        hist["stim"] = torch.as_tensor(stims, dtype=torch.int32)
    out = {k: v.cpu().numpy() for k, v in hist.items()}
    out["w_signed_final"] = state.w_signed.cpu().numpy()
    if telemetry:
        out["telemetry"] = obs_trace.summary(state.tele)
    return out, state, meta


def host_loop_trial(trial, state: ExperimentState, stim, events, xi):
    """Host-in-the-loop baseline (``repro/core/hybrid.py:613-620``): every
    state tensor crosses to the host and back before the trial, and the
    metrics come back to the host after it."""
    dev = state.w_signed.device
    state = _rebuild(state, [x.cpu().to(dev) for x in _leaves(state)])
    new, m = trial(state, stim, events, xi)
    return new, {k: v.cpu() for k, v in m.items()}


# ---------------------------------------------------------------------------
# Dry-run cell for --arch bss2: a fleet of full-size chips learning in
# parallel (``repro/core/hybrid.py:627-706``)
# ---------------------------------------------------------------------------

def bss2_cell_fleet(shape, mesh_cfg) -> Tuple[int, int, int]:
    """``(n_inst, n_local, n_cols)``: the fleet, ``max(global_batch, 16)``
    full chips, what one rank runs of it and the synapse columns of each
    of its chips, by the rule of ``ShardingCtx.instance_pspec`` (the
    reference's ``spec_for``): the fleet over the data axes and the
    chip's 512 columns over ``model``, each whole where those axes do not
    divide it. A rank's column count must be even (the reward's parity,
    ``column_part``)."""
    from repro_torch.parallel.sharding import MeshShape, ShardingCtx
    n_inst, C = max(shape.global_batch, 16), BSS2.n_cols
    ctx = ShardingCtx(mesh=MeshShape(mesh_cfg.shape, mesh_cfg.axes),
                      mesh_cfg=mesh_cfg)
    spec = ctx.instance_pspec((n_inst, BSS2.n_rows, C), cols=C)
    n_local = n_inst // ctx.dp_size if spec[0] is not None else n_inst
    n_cols = C // ctx.model_size if spec[-1] is not None else C
    if n_cols % 2:
        raise ValueError(f"{C} columns over a model axis of "
                         f"{ctx.model_size}: {n_cols} a rank, not even "
                         f"(reward parity)")
    return n_inst, n_local, n_cols


def bss2_cell_experiment(shape, mesh_cfg, device, seed: int = 0,
                         part: int = 0, whole: bool = False):
    """One rank's part of the cell: its local fleet (``bss2_cell_fleet``)
    of full ``BSS2`` chips with the reference's ``RSTDPConfig(128, 512,
    pattern_size=24, trial_steps=128)``, its columns split over ``model``:
    ``column_part`` of the ``model`` rank ``part``. The whole chips'
    instance comes from a CPU generator seeded with ``seed``, two trials'
    draws of stimulus A from one seeded with ``seed + 1``, both cut to the
    part: the same numbers on every device and in every part. ``whole``
    runs the whole chips instead (what the parts gathered equal). Returns
    ``(init, trial, meta, draws, n_local)``.

    The backend is "blocked", what "auto" picks on the card, pinned so
    that the CPU runs the same kernel wrappers (their plain versions)
    and counts the same work."""
    _, n_local, n_cols = bss2_cell_fleet(shape, mesh_cfg)
    cfg = BSS2
    ecfg = RSTDPConfig(n_inputs=cfg.n_rows // 2, n_neurons=cfg.n_cols,
                       pattern_size=24, trial_steps=128)
    init, trial, meta = column_part(
        cfg, ecfg, 1 if whole else cfg.n_cols // n_cols, part,
        generator=torch.Generator().manual_seed(seed), prefix=(n_local,),
        backend="blocked", device=device)
    draws = meta["draw"](torch.Generator().manual_seed(seed + 1), [1, 1])
    return init, trial, meta, draws, n_local


def trace_bss2_cell(shape, mesh_cfg, device, seed: int = 0):
    """The cell's per-device roofline (``lower_bss2_cell``'s counterpart):
    one eager trial of this rank's part, the local fleet x the rank's
    columns (``bss2_cell_experiment``, the first ``model`` rank's: every
    part counts the same), after a warm-up trial, under a ``cost``
    recorder on ``device`` (the kernels on the card, their plain versions
    on the CPU: the same counts). Returns ``(report, recorder,
    n_local)``.

    No collective is recorded: the instances are independent, and
    nothing in a trial couples the columns (``column_part``). The column
    work (the synaptic product, the neuron scan, the sensors, the rule)
    is the part's; the row work (the STP scan and its census, the events)
    is the whole chip's on every rank of a ``model`` group."""
    from repro_torch.analysis import cost
    from repro_torch.analysis.roofline import build_report
    device = resolve_device(device)
    init, trial, meta, draws, n_local = bss2_cell_experiment(
        shape, mesh_cfg, device, seed)
    stim = torch.tensor(1, dtype=torch.int32, device=device)
    state, _ = trial(init(), stim, draws.events[0], draws.xi[0])
    args = (state, stim, draws.events[1], draws.xi[1])
    with cost.recording() as rec:
        rec.begin(args)
        out = trial(*args)
        rec.end(out)
    del out
    # MODEL_FLOPS, the reference's formula (repro/core/hybrid.py:688-
    # 691): the event matmul, the neuron and sensor updates and the
    # correlation outer product, a step and instance
    cfg = BSS2
    flops = (2 * cfg.n_rows * cfg.n_cols + 40 * cfg.n_cols
             + 4 * cfg.n_rows * cfg.n_cols) * 128 * max(shape.global_batch,
                                                        16)
    rep = build_report(
        "bss2", shape, "2x16x16" if mesh_cfg.multi_pod else "16x16",
        mesh_cfg.n_devices, rec, model_flops_global=flops,
        step_kind="train")
    return rep, rec, n_local
