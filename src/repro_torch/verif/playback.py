"""Playback-program co-simulation (paper §2.3 + §3.1, Fig. 2).

On the real system, compiled *playback programs* (timed instruction
streams) are executed by the FPGA against the chip; the same programs run
against the RTL simulation, making hardware and simulation transparently
interchangeable. Here the two interchangeable backends are:

  * ``fast`` — the port's machine model (``AnnCore.run`` and
    ``VectorUnit.run_program_fixed``: the CUDA kernels on the card, their
    plain versions on the CPU);
  * ``ref``  — an independent pure-NumPy re-implementation of the same
    behavioural equations, written as a straight per-timestep loop (a
    copy of the reference's ``RefBackend``).

``execute`` runs a program on either backend and returns an *experiment
trace* (timestamped read-back records, like the FPGA's trace memory);
``compare_traces`` diffs two traces — that is the co-simulation check.
The instruction constructors are numpy, as in the reference
(``repro/verif/playback.py``). ``telemetry=True`` accumulates the
counters of ``repro_torch.obs.trace`` over a fast-backend program;
``faults=`` injects the same ``repro_torch.faults`` overlay into either
backend, so the co-simulation check extends to faulted silicon. The
reference's ``ppu_executor`` option is not ported (the port has one VM).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.bss2 import BSS2Config
from repro_torch.core.anncore import AnnCore
from repro_torch.core.ppu import VectorUnit
from repro_torch.faults.model import as_plans
from repro_torch.obs import trace as obs_trace
from repro_torch.ppuvm import isa
from repro_torch.verif.mismatch import (PHASE_OF_KIND, first_divergence,
                                        ideal_instance)


# ---------------------------------------------------------------------------
# Instruction set
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Instr:
    op: str                      # WRITE_WEIGHTS | WRITE_ADDRESSES | RUN |
    #                              INJECT | READ_RATES | READ_WEIGHTS |
    #                              READ_V | READ_CORR |
    #                              WRITE_PPU_PROGRAM | PPU_RUN
    payload: Any = None


def write_weights(w) -> Instr:
    return Instr("WRITE_WEIGHTS", np.asarray(w, np.int8))


def write_addresses(a) -> Instr:
    return Instr("WRITE_ADDRESSES", np.asarray(a, np.int8))


def inject(events, addrs=None) -> Instr:
    """events: [T, R] floats in {0,1} released over the next T steps."""
    ev = np.asarray(events, np.float32)
    ad = np.zeros(ev.shape, np.int8) if addrs is None else np.asarray(addrs, np.int8)
    return Instr("INJECT", (ev, ad))


def run(steps: int) -> Instr:
    return Instr("RUN", int(steps))


def read_rates() -> Instr:
    return Instr("READ_RATES")


def read_weights() -> Instr:
    return Instr("READ_WEIGHTS")


def read_v() -> Instr:
    return Instr("READ_V")


def read_corr() -> Instr:
    return Instr("READ_CORR")


def write_ppu_program(words) -> Instr:
    """Upload a PPU-VM program (``repro_torch.ppuvm``): dense int32 words."""
    words = np.asarray(words, np.int32)
    isa.validate(words)
    return Instr("WRITE_PPU_PROGRAM", words)


def ppu_run(mod=None, noise=None) -> Instr:
    """Execute the uploaded PPU-VM program against the machine state.

    ``mod`` [n_mod, C] / ``noise`` [R, C] floats are digitized to Q8.8
    HERE (host side, once) so both co-sim backends consume identical
    integers — the analog observables (CADC codes) are the only inputs
    each backend digitizes itself. Appends a ("PPU_W") weight record to
    the trace: the co-simulation check for *programs*.
    """
    mod_fp = None if mod is None else isa.to_fixed(mod)
    noise_fp = None if noise is None else isa.to_fixed(noise)
    return Instr("PPU_RUN", (mod_fp, noise_fp))


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------

def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class FastBackend:
    """The port's machine model on ``device`` (``None`` means ``cuda`` and
    raises without a card). A program uploaded with ``WRITE_PPU_PROGRAM``
    is put on the device once; each ``PPU_RUN`` runs it through
    ``VectorUnit.run_program_fixed`` (the ``ppuvm_exec`` kernel on the
    card).

    ``telemetry=True`` accumulates the counters over the whole program
    (emulation windows, route decisions, VM runs and saturation-rail
    hits), read with ``telemetry_summary()``; the trace is bit-identical
    either way. ``faults``: a ``repro_torch.faults`` overlay injected into
    the core and the vector unit."""

    def __init__(self, cfg: BSS2Config, inst=None, device=None,
                 telemetry: bool = False, faults=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.inst = inst or ideal_instance(cfg, device=self.device)
        self.core = AnnCore(cfg, self.inst, faults=faults)
        self.state = self.core.init_state()
        self._ppu = VectorUnit(cfg, self.inst, faults=faults)
        self._ppu_prog = None
        self.tele = (obs_trace.init_telemetry(self.device) if telemetry
                     else None)

    def telemetry_summary(self):
        """Host summary of the accumulated counters (``None`` when off)."""
        return obs_trace.summary(self.tele)

    def _t(self, x):
        return torch.as_tensor(np.asarray(x), device=self.device)

    def execute(self, program: List[Instr]) -> List[Tuple[int, str, np.ndarray]]:
        trace = []
        t = 0
        for ins in program:
            if ins.op == "WRITE_WEIGHTS":
                self.state = self.state._replace(
                    syn=self.state.syn._replace(weights=self._t(ins.payload)))
            elif ins.op == "WRITE_ADDRESSES":
                self.state = self.state._replace(
                    syn=self.state.syn._replace(addresses=self._t(ins.payload)))
            elif ins.op in ("INJECT", "RUN"):
                if ins.op == "INJECT":
                    ev, ad = (self._t(x) for x in ins.payload)
                else:
                    shape = (ins.payload, self.cfg.n_rows)
                    ev = torch.zeros(shape, device=self.device)
                    ad = torch.zeros(shape, dtype=torch.int8,
                                     device=self.device)
                self.state, out = self.core.run(self.state, ev, ad,
                                                telemetry=self.tele)
                self.tele = out.get("telemetry")
                t += ev.shape[0]
                trace.append((t, "SPIKES", _np(out["spikes"])))
            elif ins.op == "READ_RATES":
                trace.append((t, "RATES", _np(self.state.rate_counters)))
            elif ins.op == "READ_WEIGHTS":
                trace.append((t, "WEIGHTS", _np(self.state.syn.weights)))
            elif ins.op == "READ_V":
                trace.append((t, "V", _np(self.state.neuron.v)))
            elif ins.op == "READ_CORR":
                trace.append((t, "CORR", _np(self.state.corr.a_causal)))
            elif ins.op == "WRITE_PPU_PROGRAM":
                self._ppu_prog = self._t(ins.payload)
            elif ins.op == "PPU_RUN":
                if self._ppu_prog is None:
                    raise ValueError("PPU_RUN before WRITE_PPU_PROGRAM")
                mod_fp, noise_fp = (None if x is None else self._t(x)
                                    for x in ins.payload)
                self.tele = obs_trace.count_trial(self.tele,
                                                  self.state.rate_counters)
                self.state, regs = self._ppu.run_program_fixed(
                    self.state, self._ppu_prog, mod_fp=mod_fp,
                    noise_fp=noise_fp)
                self.tele = obs_trace.count_vm(self.tele, regs)
                trace.append((t, "PPU_W", _np(self.state.syn.weights)))
            else:
                raise ValueError(ins.op)
        return trace


class RefBackend:
    """Independent straight-loop NumPy implementation of the same machine
    (LIF + exp term, STP, address-matched synapses, correlation sensors),
    a copy of the reference's ``RefBackend``.

    ``faults`` applies the same overlay of host ``FaultPlan``s as the fast
    backend, re-implemented as straight NumPy at the same hook sites."""

    def __init__(self, cfg: BSS2Config, inst=None, faults=None):
        self.faults = as_plans(faults)
        self.cfg = cfg
        inst = inst or ideal_instance(cfg, device="cpu")
        self.p = {k: _np(v) for k, v in inst["neuron_params"].items()}
        self.gain = _np(inst["weight_gain"])
        self.stp_offset = _np(inst["stp_offset"])
        self.stp_calib = _np(inst["stp_calib"])
        self.cadc_offset = _np(inst["cadc_offset"]).astype(np.float32)
        self.cadc_gain = _np(inst["cadc_gain"]).astype(np.float32)
        self.ppu_prog = None
        r, c = cfg.n_rows, cfg.n_cols
        self.w = np.zeros((r, c), np.int8)
        self.addr = np.zeros((r, c), np.int8)
        # float32 state: the co-sim target is semantic equivalence with the
        # fp32 fast backend, not extended-precision integration
        f32 = np.float32
        self.p = {k: v.astype(f32) for k, v in self.p.items()}
        self.gain = self.gain.astype(f32)
        self.stp_offset = self.stp_offset.astype(f32)
        self.v = self.p["e_leak"].copy()
        self.wad = np.zeros(c, f32)
        self.i_exc = np.zeros(c, f32)
        self.i_inh = np.zeros(c, f32)
        self.refrac = np.zeros(c, f32)
        self.stp_r = np.ones(r, f32)
        self.tr_pre = np.zeros(r, f32)
        self.tr_post = np.zeros(c, f32)
        self.a_causal = np.zeros((r, c), f32)
        self.a_acausal = np.zeros((r, c), f32)
        self.rates = np.zeros(c, f32)

    def _step(self, ev, ad):
        cfg, p, dt = self.cfg, self.p, self.cfg.dt
        from repro_torch.core.stp import CALIB_STEP, CALIB_BITS
        for fp in self.faults:                 # dead synapse drivers
            if fp.dead_rows is not None:
                ev = ev * (~fp.dead_rows).astype(np.float32)
        trim = ((self.stp_calib.astype(np.float32) - 2 ** (CALIB_BITS - 1))
                * np.float32(CALIB_STEP))
        eff = np.clip(cfg.stp_u * self.stp_r * (1.0 + self.stp_offset - trim),
                      0.0, 1.5) * ev
        self.stp_r = np.clip(
            self.stp_r + (1 - self.stp_r) * (1 - np.exp(-dt / cfg.stp_tau_rec))
            - cfg.stp_u * self.stp_r * ev, 0.0, 1.0)

        w_read = self.w
        for fp in self.faults:                 # stuck cells at the read
            if fp.stuck_w_mask is not None:
                w_read = np.where(fp.stuck_w_mask,
                                  fp.stuck_w_val.astype(w_read.dtype),
                                  w_read)
        i_cols = np.zeros((2, cfg.n_cols))
        for half in (0, 1):
            rows = slice(half, None, 2)
            match = (self.addr[rows] == ad[rows][:, None])
            weff = w_read[rows].astype(np.float32) * match
            i_cols[half] = (weff * eff[rows][:, None]).sum(0) * self.gain

        de = np.exp(-dt / p["tau_syn_exc"])
        di = np.exp(-dt / p["tau_syn_inh"])
        self.i_exc = self.i_exc * de + i_cols[0] * 60.0
        self.i_inh = self.i_inh * di + i_cols[1] * 60.0
        i_total = self.i_exc - self.i_inh - self.wad

        if cfg.neuron.adex:
            arg = np.clip((self.v - p["v_thres"]) / p["delta_t"], -20.0, 3.0)
            i_exp = p["g_leak"] * p["delta_t"] * np.exp(arg)
        else:
            i_exp = 0.0
        tau_m = p["c_mem"] / p["g_leak"]
        v_inf = p["e_leak"] + (i_total + i_exp) / p["g_leak"]
        v = v_inf + (self.v - v_inf) * np.exp(-dt / tau_m)
        w_inf = p["a"] * (self.v - p["e_leak"])
        wad = w_inf + (self.wad - w_inf) * np.exp(-dt / p["tau_w"])

        in_ref = self.refrac > 0
        v = np.where(in_ref, p["e_reset"], v)
        wad = np.where(in_ref, self.wad, wad)
        spike_v = p["v_thres"] + (2.0 * p["delta_t"] if cfg.neuron.adex else 0.0)
        spikes = (v > spike_v) & ~in_ref
        v = np.where(spikes, p["e_reset"], v)
        wad = np.where(spikes, wad + p["b"], wad)
        self.refrac = np.where(spikes, p["tau_refrac"],
                               np.maximum(self.refrac - dt, 0.0))
        self.v, self.wad = v, wad
        sp = spikes.astype(np.float32)
        for fp in self.faults:                 # output-driver faults: the
            if fp.hot_neurons is not None:     # membrane above integrated
                sp = np.where(fp.hot_neurons, np.float32(1.0), sp)
            if fp.dead_neurons is not None:    # unmasked, like AnnCore
                sp = sp * (~fp.dead_neurons).astype(np.float32)

        # correlation sensors (nominal scalar tau, as in AnnCore.step)
        tau = cfg.neuron.tau_syn_exc
        self.tr_pre = self.tr_pre * np.exp(-dt / tau) + ev
        self.tr_post = self.tr_post * np.exp(-dt / tau) + sp
        self.a_causal = np.minimum(
            self.a_causal + self.tr_pre[:, None] * sp[None, :], 1023.0)
        self.a_acausal = np.minimum(
            self.a_acausal + ev[:, None] * self.tr_post[None, :], 1023.0)
        self.rates += sp
        return sp

    def _cadc_digitize(self, a):
        """NumPy twin of cadc.digitize as used by VectorUnit (in_scale=8)."""
        lsb = 2 ** self.cfg.cadc_bits - 1
        code = a * (self.cadc_gain[None, :] * 8.0) + self.cadc_offset[None, :]
        q = np.clip(np.round(code), 0, lsb).astype(np.int32)
        for fp in self.faults:                 # corrupted CADC columns
            if fp.cadc_code_offset is not None:
                q = np.clip(q + fp.cadc_code_offset[None, :], 0, lsb)
            if fp.cadc_stuck_mask is not None:
                q = np.where(fp.cadc_stuck_mask[None, :],
                             fp.cadc_stuck_code[None, :], q)
        return q

    def _ppu_run(self, mod_fp, noise_fp):
        from repro_torch.ppuvm.interp import run_program_np

        if self.ppu_prog is None:
            raise ValueError("PPU_RUN before WRITE_PPU_PROGRAM")
        qc = self._cadc_digitize(self.a_causal)
        qa = self._cadc_digitize(self.a_acausal)
        w_new, _ = run_program_np(self.ppu_prog, self.w.astype(np.int32),
                                  qc, qa, self.rates, mod_fp, noise_fp)
        for fp in self.faults:                 # store-path faults
            if fp.store_flip is not None:
                w_new = w_new ^ fp.store_flip.astype(w_new.dtype)
            if fp.store_zero is not None:
                w_new = np.where(fp.store_zero, 0, w_new)
        self.w = w_new.astype(np.int8)
        # post-read observable reset, like VectorUnit._reset_observables
        self.rates = np.zeros_like(self.rates)
        self.a_causal = np.zeros_like(self.a_causal)
        self.a_acausal = np.zeros_like(self.a_acausal)

    def execute(self, program: List[Instr]) -> List[Tuple[int, str, np.ndarray]]:
        trace = []
        t = 0
        for ins in program:
            if ins.op == "WRITE_WEIGHTS":
                self.w = ins.payload.copy()
            elif ins.op == "WRITE_ADDRESSES":
                self.addr = ins.payload.copy()
            elif ins.op in ("INJECT", "RUN"):
                if ins.op == "INJECT":
                    ev, ad = ins.payload
                else:
                    ev = np.zeros((ins.payload, self.cfg.n_rows), np.float32)
                    ad = np.zeros_like(ev, dtype=np.int8)
                sp = np.stack([self._step(ev[i], ad[i])
                               for i in range(ev.shape[0])])
                t += ev.shape[0]
                trace.append((t, "SPIKES", sp))
            elif ins.op == "READ_RATES":
                trace.append((t, "RATES", self.rates.copy()))
            elif ins.op == "READ_WEIGHTS":
                trace.append((t, "WEIGHTS", self.w.copy()))
            elif ins.op == "READ_V":
                trace.append((t, "V", self.v.copy()))
            elif ins.op == "READ_CORR":
                trace.append((t, "CORR", self.a_causal.copy()))
            elif ins.op == "WRITE_PPU_PROGRAM":
                self.ppu_prog = ins.payload.copy()
            elif ins.op == "PPU_RUN":
                self._ppu_run(*ins.payload)
                trace.append((t, "PPU_W", self.w.copy()))
            else:
                raise ValueError(ins.op)
        return trace


def execute(program: List[Instr], backend: str, cfg: BSS2Config, inst=None,
            device=None, telemetry: bool = False, faults=None):
    """Run a playback program. ``backend`` is "fast" (the port's machine
    model on ``device``; ``None`` means ``cuda``) or "ref" (independent
    NumPy loop, always on the host). ``telemetry`` counts on the fast
    backend (the reference stays uninstrumented by design); ``faults``
    injects the same overlay into either backend."""
    if backend == "fast":
        return FastBackend(cfg, inst, device=device, telemetry=telemetry,
                           faults=faults).execute(program)
    if backend == "ref":
        return RefBackend(cfg, inst, faults=faults).execute(program)
    raise ValueError(f"unknown backend {backend!r}")


def compare_traces(a, b, atol=1e-3) -> List[str]:
    """Diff two experiment traces; returns a list of mismatch descriptions
    (empty == co-simulation PASS). Every value mismatch is localized
    through ``repro_torch.verif.mismatch.first_divergence``: the message
    names the emulation phase, the absolute timestep (for time-leading
    records), and the first differing array index."""
    errs = []
    if len(a) != len(b):
        errs.append(f"trace length {len(a)} != {len(b)}")
    for i, ((ta, ka, va), (tb, kb, vb)) in enumerate(zip(a, b)):
        if ta != tb or ka != kb:
            errs.append(f"[{i}] header ({ta},{ka}) != ({tb},{kb})")
            continue
        va, vb = np.asarray(va, np.float64), np.asarray(vb, np.float64)
        if va.shape != vb.shape:
            errs.append(f"[{i}] {ka}@{ta}: shape {va.shape} != {vb.shape}")
        elif not np.allclose(va, vb, atol=atol, rtol=1e-4):
            d = first_divergence([(ta, ka, va)], [(tb, kb, vb)], atol=atol)
            at_step = "" if d.step is None else f" step {d.step},"
            errs.append(
                f"[{i}] {ka}@{ta}: max|diff|={d.max_abs:.3e} "
                f"(phase {PHASE_OF_KIND.get(ka, '?')},{at_step} first at "
                f"index {d.where}: {d.a:g} vs {d.b:g}, "
                f"{d.n_mismatch} element(s))")
    return errs
