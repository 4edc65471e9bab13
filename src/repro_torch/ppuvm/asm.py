"""Tiny assembler for PPU-VM programs.

``Asm`` accumulates instructions and emits a dense ``int32`` word array —
the artifact that crosses the playback-program boundary (the co-development
story of paper §3.1: the SAME word stream executes on the CUDA kernel,
the plain PyTorch version and the independent NumPy interpreter). A copy
of ``repro/ppuvm/asm.py``.

    a = Asm()
    w, elig = a.reg("w"), a.reg("elig")
    a.ldw(w)
    a.ldcausal(elig)
    ...
    words = a.build()
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.ppuvm import isa


class Asm:
    def __init__(self):
        self.words: List[int] = []
        self._names: Dict[str, int] = {}

    # -- register allocation ------------------------------------------------
    def reg(self, name: str) -> int:
        """Allocate (or look up) a named register."""
        if name not in self._names:
            if len(self._names) >= isa.N_REGS:
                raise ValueError(f"out of registers (n_regs={isa.N_REGS})")
            self._names[name] = len(self._names)
        return self._names[name]

    # -- emit helpers ---------------------------------------------------------
    def _emit(self, op, rd=0, ra=0, imm16=0) -> "Asm":
        self.words.append(isa.encode(op, rd, ra, imm16))
        return self

    def nop(self):
        return self._emit(isa.NOP)

    def splat(self, rd, value: float):
        """rd <- Q8.8 constant (saturating encode of ``value``)."""
        return self._emit(isa.SPLAT, rd, 0, isa.splat_imm(value))

    def mov(self, rd, ra):
        return self._emit(isa.MOV, rd, ra)

    def add(self, rd, ra, rb):
        return self._emit(isa.ADD, rd, ra, isa.alu_imm(rb))

    def sub(self, rd, ra, rb):
        return self._emit(isa.SUB, rd, ra, isa.alu_imm(rb))

    def mulf(self, rd, ra, rb, shift: int = isa.FRAC):
        """Fracsat multiply: rd <- sat((ra*rb + round) >> shift)."""
        return self._emit(isa.MULF, rd, ra, isa.alu_imm(rb, shift))

    def shl(self, rd, ra, shamt: int):
        return self._emit(isa.SHL, rd, ra, isa.alu_imm(0, shamt))

    def shr(self, rd, ra, shamt: int):
        return self._emit(isa.SHR, rd, ra, isa.alu_imm(0, shamt))

    def cmpge(self, rd, ra, rb):
        return self._emit(isa.CMPGE, rd, ra, isa.alu_imm(rb))

    def sel(self, rd, ra, rb):
        """Blend: rd <- ra where rd != 0 else rb."""
        return self._emit(isa.SEL, rd, ra, isa.alu_imm(rb))

    def vmax(self, rd, ra, rb):
        return self._emit(isa.MAXS, rd, ra, isa.alu_imm(rb))

    def vmin(self, rd, ra, rb):
        return self._emit(isa.MINS, rd, ra, isa.alu_imm(rb))

    def ldw(self, rd):
        return self._emit(isa.LDW, rd)

    def stw(self, ra):
        return self._emit(isa.STW, 0, ra)

    def ldcausal(self, rd):
        return self._emit(isa.LDCAUSAL, rd)

    def ldacausal(self, rd):
        return self._emit(isa.LDACAUSAL, rd)

    def ldrate(self, rd):
        return self._emit(isa.LDRATE, rd)

    def ldmod(self, rd, slot: int = 0):
        return self._emit(isa.LDMOD, rd, 0, slot)

    def ldnoise(self, rd):
        return self._emit(isa.LDNOISE, rd)

    # -- build ----------------------------------------------------------------
    def build(self) -> np.ndarray:
        """Dense int32 instruction words (the uploadable program image)."""
        return np.asarray(self.words, np.int32)

    def disassemble(self) -> str:
        return isa.disassemble(self.build())
