"""Plain PyTorch version of the ppuvm_exec kernel: the whole PPU-VM
program over the lane plane.

The words are decoded on the host once, and each word applies its
opcode's torch op to the whole [*lane] plane (the form of the reference's
trace-time specializer, ``repro/ppuvm/specialize.py:43-81``). The
per-opcode semantics are the reference's ``make_semantics``
(``repro/ppuvm/interp.py:96-150``): registers are int32 planes, results
saturate to the int16 range, shifts clamp (MULF 16, SHL 15, SHR 31), SEL
reads the destination before writing it, LDMOD clips its slot to the
slots present, STW's store is the live weight that a later LDW reads, and
opcodes >= N_OPS run as NOP.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.ppuvm import isa
from repro_torch.ppuvm.interp import _sat, prepare_operands


def run_program_ref(words, weights, qc, qa, rates, mod=None, noise=None):
    """Same operands and returns as ``repro_torch.ppuvm.interp
    .run_program``: ``(weights_out int32 [..., R, C], regs int32
    [N_REGS, ..., R, C])``."""
    lane = weights.shape
    wmem, qc, qa, rates_fx, mod, noise = prepare_operands(
        weights, qc, qa, rates, mod, noise)
    zero = torch.zeros(lane, dtype=torch.int32, device=weights.device)
    regs = [zero] * isa.N_REGS
    n_mod = mod.shape[0]
    if isinstance(words, torch.Tensor):
        words = words.cpu().numpy()
    for word in np.asarray(words).astype(np.int64).reshape(-1):
        op, rd, ra, rb, sh, simm = isa.decode(int(word))
        rd %= isa.N_REGS
        a = regs[ra % isa.N_REGS]
        b = regs[rb % isa.N_REGS]
        if op == isa.SPLAT:
            val = torch.full(lane, simm, dtype=torch.int32,
                             device=weights.device)
        elif op == isa.MOV:
            val = a
        elif op == isa.ADD:
            val = _sat(a + b)
        elif op == isa.SUB:
            val = _sat(a - b)
        elif op == isa.MULF:
            shc = min(sh, 16)
            val = _sat((a * b + ((1 << shc) >> 1)) >> shc)
        elif op == isa.SHL:
            val = _sat(a << min(sh, 15))
        elif op == isa.SHR:
            val = a >> min(sh, 31)
        elif op == isa.CMPGE:
            val = torch.where(a >= b, isa.ONE, 0).to(torch.int32)
        elif op == isa.SEL:
            val = torch.where(regs[rd] != 0, a, b)
        elif op == isa.MAXS:
            val = torch.maximum(a, b)
        elif op == isa.MINS:
            val = torch.minimum(a, b)
        elif op == isa.LDW:
            val = wmem << isa.FRAC
        elif op == isa.STW:
            wmem = torch.clamp((a + (isa.ONE >> 1)) >> isa.FRAC, 0,
                               isa.WMAX)
            continue
        elif op == isa.LDCAUSAL:
            val = qc
        elif op == isa.LDACAUSAL:
            val = qa
        elif op == isa.LDRATE:
            val = rates_fx
        elif op == isa.LDMOD:
            val = mod[min(simm & 0xFF, n_mod - 1)]
        elif op == isa.LDNOISE:
            val = noise
        else:                        # NOP and unknown opcodes
            continue
        regs[rd] = val
    return wmem.contiguous(), torch.stack(regs)
