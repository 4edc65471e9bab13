"""Executors of the PPU-VM ISA (paper §3.1): the port's front door.

One function, three implementations of it, all integer-exact:

``run_program``
    Dispatches by the device of its tensors, like every kernel wrapper of
    the port: CPU tensors run the plain PyTorch version
    (``kernels/ppuvm_exec/ref.py``: the words decoded on the host once,
    each opcode applied to the whole lane plane), CUDA tensors launch the
    ``ppuvm_exec`` kernel (``csrc/ppuvm_exec.cu``: the whole program per
    lane, registers on the card) or raise. There is no knob that picks
    the plain version on the card.

``run_program_np``
    The independent straight-loop NumPy interpreter, a verbatim copy of
    the reference's (``repro/ppuvm/interp.py``). Playback's ``RefBackend``
    runs it.

Inputs (see ``repro_torch.ppuvm.isa`` for the numeric model):
  words    [P]            int32 instruction stream (for ``run_program`` a
                          tensor on the operands' device, or host words
                          when the operands lie on the CPU)
  weights  [..., R, C]    integer synapse weights (0..63)
  qc, qa   [..., R, C]    int CADC causal / anti-causal codes (0..255)
  rates    [..., C]       per-column rate counters (integer-valued)
  mod      [n_mod, ..., C] Q8.8 per-column modulator slots
  noise    [..., R, C]    Q8.8 per-synapse noise plane

Returns ``(weights_out, regs)``: ``weights_out`` int32 ``[..., R, C]`` and
``regs`` the final ``[N_REGS, ..., R, C]`` int32 register file (programs
use it as a scratch readout, like the PPU's scratch SRAM).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.ppuvm import isa

assert isa.FRAC == 8, "CADC fractional loads assume Q8.8"


def _sat(x):
    return torch.clamp(x, isa.I16MIN, isa.I16MAX)


def rates_to_fixed(rates):
    """Rate counters (integer-valued float) -> saturated Q8.8 int32: round
    half to even, cast to int32, shift by FRAC, then saturate (the
    reference's order, ``repro/ppuvm/interp.py:91-94``)."""
    return _sat(torch.round(rates).to(torch.int32) << isa.FRAC)


def prepare_operands(weights, qc, qa, rates, mod=None, noise=None):
    """Broadcast/digitize the operand planes to the lane shape: int32
    weights, int32 qc/qa, saturated fixed-point rates, [n_mod, *lane]
    modulator slots, int32 noise (``repro/ppuvm/interp.py:71-89``)."""
    lane_shape = weights.shape
    dev = weights.device
    wmem = weights.to(torch.int32)
    qc = torch.broadcast_to(qc, lane_shape).to(torch.int32)
    qa = torch.broadcast_to(qa, lane_shape).to(torch.int32)
    rates_fx = torch.broadcast_to(rates_to_fixed(rates).unsqueeze(-2),
                                  lane_shape)
    if mod is None:
        mod = torch.zeros((1, *lane_shape[:-2], lane_shape[-1]),
                          dtype=torch.int32, device=dev)
    mod = torch.broadcast_to(mod.unsqueeze(-2),
                             (mod.shape[0], *lane_shape)).to(torch.int32)
    if noise is None:
        noise = torch.zeros(lane_shape, dtype=torch.int32, device=dev)
    noise = torch.broadcast_to(noise, lane_shape).to(torch.int32)
    return wmem, qc, qa, rates_fx, mod, noise


def run_program(words, weights, qc, qa, rates, mod=None, noise=None):
    """Run a PPU-VM program on the device of ``weights`` (see the module
    docstring). Returns ``(weights_out int32, regs int32)``."""
    from repro_torch.kernels.ppuvm_exec import ops
    return ops.run_program(words, weights, qc, qa, rates, mod, noise)


# ---------------------------------------------------------------------------
# NumPy executor (independent reference — keep free of torch)
# ---------------------------------------------------------------------------

def run_program_np(words, weights, qc, qa, rates, mod=None, noise=None):
    lane_shape = np.shape(weights)
    wmem = np.asarray(weights, np.int32).copy()
    qc = np.broadcast_to(np.asarray(qc, np.int32), lane_shape)
    qa = np.broadcast_to(np.asarray(qa, np.int32), lane_shape)
    rates_fx = _sat_n(np.round(np.asarray(rates)).astype(np.int32)
                      << isa.FRAC)
    rates_fx = np.broadcast_to(rates_fx[..., None, :], lane_shape)
    if mod is None:
        mod = np.zeros((1, *lane_shape[:-2], lane_shape[-1]), np.int32)
    mod = np.asarray(mod, np.int32)
    if noise is None:
        noise = np.zeros(lane_shape, np.int32)
    noise = np.broadcast_to(np.asarray(noise, np.int32), lane_shape)

    regs = np.zeros((isa.N_REGS, *lane_shape), np.int32)
    for word in np.asarray(words, np.int64):
        op, rd, ra, rb, sh, simm = isa.decode(int(word))
        rd %= isa.N_REGS
        a = regs[ra % isa.N_REGS]
        b = regs[rb % isa.N_REGS]
        if op == isa.NOP:
            pass
        elif op == isa.SPLAT:
            regs[rd] = simm
        elif op == isa.MOV:
            regs[rd] = a
        elif op == isa.ADD:
            regs[rd] = _sat_n(a + b)
        elif op == isa.SUB:
            regs[rd] = _sat_n(a - b)
        elif op == isa.MULF:
            shc = min(sh, 16)
            regs[rd] = _sat_n((a * b + ((1 << shc) >> 1)) >> shc)
        elif op == isa.SHL:
            regs[rd] = _sat_n(a << min(sh, 15))
        elif op == isa.SHR:
            regs[rd] = a >> min(sh, 31)
        elif op == isa.CMPGE:
            regs[rd] = np.where(a >= b, isa.ONE, 0)
        elif op == isa.SEL:
            regs[rd] = np.where(regs[rd] != 0, a, b)
        elif op == isa.MAXS:
            regs[rd] = np.maximum(a, b)
        elif op == isa.MINS:
            regs[rd] = np.minimum(a, b)
        elif op == isa.LDW:
            regs[rd] = wmem << isa.FRAC
        elif op == isa.STW:
            wmem = np.clip((a + (isa.ONE >> 1)) >> isa.FRAC,
                           0, isa.WMAX).astype(np.int32)
        elif op == isa.LDCAUSAL:
            regs[rd] = qc
        elif op == isa.LDACAUSAL:
            regs[rd] = qa
        elif op == isa.LDRATE:
            regs[rd] = rates_fx
        elif op == isa.LDMOD:
            regs[rd] = np.broadcast_to(
                mod[min(simm & 0xFF, mod.shape[0] - 1)][..., None, :],
                lane_shape)
        elif op == isa.LDNOISE:
            regs[rd] = noise
        # unknown opcodes are NOPs, matching the JAX executor
    return wmem, regs


def _sat_n(x):
    return np.clip(x, isa.I16MIN, isa.I16MAX).astype(np.int32)
