"""Plasticity Processing Unit — vector-unit semantics (paper §2.2).

A plasticity rule is a function over (weights, observables, rule state)
applied to all rows and columns at once; weight writes saturate to 6 bit
like the hardware store. Ported: the observable reads, the generic
``apply_rule`` path that the §5 Dale-signed rule runs on, the reset, and
the fixed-function standard rule ``apply_rstdp`` (the ``ppu_update``
kernel), and the PPU-VM: ``run_program`` / ``run_program_fixed`` run an
uploaded instruction-word program (``repro_torch.ppuvm``, the
``ppuvm_exec`` kernel on the card) and ``apply_rstdp_program`` runs the
R-STDP rule as one. A fault overlay (``faults=``) adds the ``cadc`` hook
to every CADC read (``read_correlation``, and inside the ``ppu_update``
kernel of ``apply_rstdp``) and the ``store`` hook to every PPU-VM weight
store (``run_program_fixed``), as ``repro/core/ppu.py`` places them.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.configs.bss2 import BSS2Config
from repro_torch.core import cadc, rules, synapse
from repro_torch.faults import inject as finject
from repro_torch.ppuvm import isa


def _to_fixed(x):
    """Float -> Q8.8 int32 (``isa.to_fixed`` on tensors): float32
    ``x * 256``, rounded half to even, saturated to int16."""
    return torch.clamp(torch.round(x.to(torch.float32) * isa.ONE),
                       isa.I16MIN, isa.I16MAX).to(torch.int32)


class VectorUnit:
    """The vector unit bound to a config and an instance. ``faults``: a
    ``repro_torch.faults`` overlay, put on the instance's device here,
    once; ``None`` is the identity on every hook."""

    def __init__(self, cfg: BSS2Config, inst: Dict, faults=None):
        self.cfg = cfg
        self.inst = inst
        device = inst["cadc_offset"].device
        self.faults = finject.on_device(faults, device)
        # the overlay's CADC hooks as one clamp-shift per column, the form
        # the ppu_update kernel applies after its rounding (None: no CADC
        # fault, the kernel as without faults)
        self._cadc_map = finject.cadc_map(self.faults, device,
                                          2 ** cfg.cadc_bits - 1)

    # -- observable reads ------------------------------------------------
    def read_correlation(self, corr_state):
        """CADC-digitized causal/anti-causal codes [..., R, C] (int32)."""
        oc = self.inst["cadc_offset"].unsqueeze(-2)
        gc = self.inst["cadc_gain"].unsqueeze(-2)
        qc = cadc.digitize(corr_state.a_causal, offset=oc, gain=gc,
                           bits=self.cfg.cadc_bits, in_scale=8.0)
        qa = cadc.digitize(corr_state.a_acausal, offset=oc, gain=gc,
                           bits=self.cfg.cadc_bits, in_scale=8.0)
        return finject.cadc(self.faults, qc, qa, 2 ** self.cfg.cadc_bits - 1)

    def read_rates(self, state):
        return state.rate_counters

    # -- weight write-back -----------------------------------------------
    def write_weights(self, syn: synapse.SynapseArray, w_new
                      ) -> synapse.SynapseArray:
        return syn._replace(weights=synapse.quantize_weight(w_new))

    # -- rule application --------------------------------------------------
    def apply_rule(self, rule: Callable, state, rule_state: Dict, **kw):
        """rule(weights_f32, observables, rule_state, **kw) ->
        (new_weights_f32, new_rule_state). All tensors are [..., R, C].
        Returns (state with observables reset, rule_state, observables)."""
        qc, qa = self.read_correlation(state.corr)
        obs = dict(causal=qc, acausal=qa, rates=self.read_rates(state))
        w = state.syn.weights.to(torch.float32)
        w_new, rule_state = rule(w, obs, rule_state, **kw)
        syn = self.write_weights(state.syn, w_new)
        return (self._reset_observables(state._replace(syn=syn)),
                rule_state, obs)

    # -- fused rule application --------------------------------------------
    def apply_rstdp(self, state, rule_state: Dict, *, reward,
                    eta: float = 0.5, gamma: float = 0.3, noise: float = 0.3,
                    xi=None, generator: torch.Generator = None):
        """Standard R-STDP (``rules.rstdp`` semantics) with the whole read
        -> eligibility -> update -> write-back loop in the ``ppu_update``
        kernel (``repro/core/ppu.py:147-196``).

        The wrapper runs on both devices (the plain version on the CPU,
        the kernel on the card), so the two agree bit for bit; an instance
        prefix folds into the kernel's N axis. ``xi``: the injected
        [..., R, C] random walk (already scaled by ``noise``, e.g.
        ``repro_torch.convert.replay_rstdp_xi``); without it the walk is
        drawn from ``generator``. Returns ``(new_state,
        dict(mean_reward=...), elig)``; observables are reset like
        ``apply_rule``.

        Under a fault overlay with CADC faults the kernel applies them to
        both codes after its rounding and before the eligibility, which is
        what the reference's ``ref`` branch computes through
        ``read_correlation`` (its Pallas branch skips the hook: ROADMAP.md
        queue 3).
        """
        from repro_torch.kernels.ppu_update import ops as ppu_ops
        mean_r = rule_state["mean_reward"]
        mean_r_new = mean_r + gamma * (reward - mean_r)          # Eq. 2
        mod = reward - mean_r
        w = state.syn.weights
        if xi is None:
            if generator is None:
                raise ValueError("apply_rstdp: pass the xi plane or a "
                                 "generator")
            xi = rules.draw_xi(w.shape, noise, generator, w.device)
        w_q, elig = ppu_ops.rstdp_update(
            w, state.corr.a_causal, state.corr.a_acausal,
            self.inst["cadc_offset"], self.inst["cadc_gain"], mod, xi,
            eta=eta, cadc_max=2 ** self.cfg.cadc_bits - 1,
            cadc_map=self._cadc_map)
        new_state = self._reset_observables(
            state._replace(syn=state.syn._replace(weights=w_q)))
        return new_state, dict(mean_reward=mean_r_new), elig

    # -- programmable rule execution (PPU-VM) -------------------------------
    def run_program(self, state, words, *, mod=None, noise=None):
        """Execute a PPU-VM program (``repro_torch.ppuvm``) against the
        machine state: the program sees the digitized CADC codes, the rate
        counters, optional per-column modulator slots (``mod`` [n_mod, ...,
        C] float) and a per-synapse noise plane (``noise`` [..., R, C]
        float), and may store new 6-bit weights. ``words``: an int32 [P]
        tensor on the state's device (uploaded once).

        Returns (new_state, regs): observables are reset like
        ``apply_rule``; ``regs`` is the final [N_REGS, ..., R, C] int32
        register file, the program's scratch readout.
        """
        mod_fp = None if mod is None else _to_fixed(mod)
        noise_fp = None if noise is None else _to_fixed(noise)
        return self.run_program_fixed(state, words, mod_fp=mod_fp,
                                      noise_fp=noise_fp)

    def run_program_fixed(self, state, words, *, mod_fp=None,
                          noise_fp=None):
        """Like ``run_program`` but with pre-digitized Q8.8 int32 modulator
        slots / noise plane, the form playback's ``PPU_RUN`` carries."""
        from repro_torch.ppuvm import interp
        qc, qa = self.read_correlation(state.corr)
        w_new, regs = interp.run_program(
            words, state.syn.weights, qc, qa, state.rate_counters, mod_fp,
            noise_fp)
        w_new = finject.store(self.faults, w_new)
        syn = state.syn._replace(weights=w_new.to(torch.int8))
        return self._reset_observables(state._replace(syn=syn)), regs

    def apply_rstdp_program(self, state, rule_state: Dict, *, reward,
                            program, gamma: float = 0.3, noise: float = 0.3,
                            xi=None, generator: torch.Generator = None):
        """R-STDP with the Eq. 3 vector part run as a PPU-VM program
        (``repro_torch.ppuvm.programs.rstdp_program``, ``program`` its
        words on the device). The scalar prologue (Eq. 2, the xi walk) is
        ``apply_rstdp``'s: ``xi`` is the injected [..., R, C] walk (already
        scaled by ``noise``, e.g. ``convert.replay_rstdp_xi``), else it is
        drawn from ``generator``. Returns ``(new_state,
        dict(mean_reward=...), regs)``."""
        mean_r = rule_state["mean_reward"]
        mean_r_new = mean_r + gamma * (reward - mean_r)          # Eq. 2
        mod = (reward - mean_r).unsqueeze(0)                     # slot 0
        w = state.syn.weights
        if xi is None:
            if generator is None:
                raise ValueError("apply_rstdp_program: pass the xi plane or "
                                 "a generator")
            xi = rules.draw_xi(w.shape, noise, generator, w.device)
        new_state, regs = self.run_program(state, program, mod=mod, noise=xi)
        return new_state, dict(mean_reward=mean_r_new), regs

    def _reset_observables(self, state):
        """Post-read reset: rate counters and correlation capacitors."""
        return state._replace(
            rate_counters=torch.zeros_like(state.rate_counters),
            corr=state.corr._replace(
                a_causal=torch.zeros_like(state.corr.a_causal),
                a_acausal=torch.zeros_like(state.corr.a_acausal)),
        )
