"""PPU-VM instruction set: SIMD fixed-point vector ops (paper §2.2, §5).

The silicon PPU couples a Power-ISA scalar core to a SIMD vector unit whose
lanes are hard-wired to synapse-array columns; plasticity kernels are
*programs* that loop over synapse rows, computing in saturating fixed point
("fracsat" in the hardware's modified-Power-ISA vector extension) and
writing 6-bit weights back through the full-custom SRAM controller (see
also arXiv:2003.11996 §"plasticity processing unit").

This module defines the VM's numeric model and opcode table; the
executors (`repro_torch.ppuvm.interp`: the plain PyTorch version, the CUDA
kernel ``ppuvm_exec`` and the independent NumPy interpreter) and the
assembler (`repro_torch.ppuvm.asm`) share it. A copy of
``repro/ppuvm/isa.py``, held equal to it by tests/test_torch_ppuvm.py.

Numeric model
-------------
Registers hold signed 16-bit fixed point in Q8.8 (``FRAC = 8`` fractional
bits, range ±128, resolution 2^-8), stored in int32 lanes; every
arithmetic result saturates to the int16 range — the hardware's halfword
fracsat mode. A program is written for ONE synapse row; the VM executes
all rows in lock-step (the register file is conceptually ``[n_regs, C]``
per row and ``[n_regs, R, C]`` for the whole array), exactly like the
hardware loops its row-parallel vector kernel over the array.

Memory / observable semantics (the hardware-shaped part):

  ``LDW``        weight row as an integer value w (raw = w << FRAC)
  ``STW``        saturating 6-bit store: w = clip(round(val), 0, 63)
  ``LDCAUSAL``/``LDACAUSAL``
                 CADC causal/anti-causal codes as *fractions of full
                 scale*: value = code / 2^8 — exact in Q8.8 (raw = code),
                 like the vector unit's fractional byte loads
  ``LDRATE``     per-column rate counter as an integer value (saturating)
  ``LDMOD``      per-column modulator slot k (scalar-core deposited, e.g.
                 R - <R>), pre-digitized to Q8.8
  ``LDNOISE``    per-synapse noise plane (the PPU's PRNG stream),
                 pre-digitized to Q8.8

Instruction encoding (one int32 word, assembled by ``repro_torch.ppuvm.asm``):

  bits [31:26] opcode   [25:21] rd   [20:16] ra   [15:0] imm16

For 3-register ALU ops ``imm16 = (rb << 8) | shamt``; for ``VSPLAT`` the
imm16 is the sign-extended Q8.8 constant; for ``LDMOD`` it is the
modulator slot index.
"""
from __future__ import annotations

import numpy as np

# --- numeric model ---------------------------------------------------------
FRAC = 8                       # fractional bits (Q8.8)
ONE = 1 << FRAC                # fixed-point 1.0
I16MIN, I16MAX = -(1 << 15), (1 << 15) - 1
WMAX = 63                      # 6-bit saturating weight store

# --- opcodes ---------------------------------------------------------------
NOP = 0
SPLAT = 1      # rd <- imm16 (sign-extended Q8.8 constant)
MOV = 2        # rd <- ra
ADD = 3        # rd <- sat(ra + rb)
SUB = 4        # rd <- sat(ra - rb)
MULF = 5       # rd <- sat((ra * rb + round) >> shamt)   fracsat multiply
SHL = 6        # rd <- sat(ra << shamt)
SHR = 7        # rd <- ra >> shamt (arithmetic)
CMPGE = 8      # rd <- ONE where ra >= rb else 0
SEL = 9        # rd <- ra where rd != 0 else rb (blend by mask in rd)
MAXS = 10      # rd <- max(ra, rb)
MINS = 11      # rd <- min(ra, rb)
LDW = 12       # rd <- weight row (integer value)
STW = 13       # weight row <- clip(round(ra), 0, 63)
LDCAUSAL = 14  # rd <- CADC causal codes / 2^8
LDACAUSAL = 15  # rd <- CADC anti-causal codes / 2^8
LDRATE = 16    # rd <- rate counters (integer value, saturating)
LDMOD = 17     # rd <- modulator slot imm16
LDNOISE = 18   # rd <- noise plane

N_OPS = 19
N_REGS = 8

MNEMONIC = {
    NOP: "nop", SPLAT: "vsplat", MOV: "vmov", ADD: "vadd", SUB: "vsub",
    MULF: "vmulf", SHL: "vshl", SHR: "vshr", CMPGE: "vcmpge", SEL: "vsel",
    MAXS: "vmax", MINS: "vmin", LDW: "ldw", STW: "stw",
    LDCAUSAL: "ldcausal", LDACAUSAL: "ldacausal", LDRATE: "ldrate",
    LDMOD: "ldmod", LDNOISE: "ldnoise",
}


# --- fixed-point conversion (host side) ------------------------------------
def to_fixed(x):
    """Float -> Q8.8 int32, round-half-even (np.round), saturating."""
    return np.clip(np.round(np.asarray(x, np.float64) * ONE),
                   I16MIN, I16MAX).astype(np.int32)


def from_fixed(x):
    """Q8.8 int32 -> float32."""
    return np.asarray(x, np.float32) / ONE


def splat_imm(value: float) -> int:
    """Encode a float constant as the 16-bit Q8.8 immediate of VSPLAT."""
    v = int(np.clip(round(float(value) * ONE), I16MIN, I16MAX))
    return v & 0xFFFF


# --- encoding --------------------------------------------------------------
def encode(op: int, rd: int = 0, ra: int = 0, imm16: int = 0) -> int:
    assert 0 <= op < (1 << 6) and 0 <= rd < (1 << 5) and 0 <= ra < (1 << 5)
    return (op << 26) | (rd << 21) | (ra << 16) | (imm16 & 0xFFFF)


def alu_imm(rb: int = 0, shamt: int = 0) -> int:
    assert 0 <= rb < (1 << 5) and 0 <= shamt < (1 << 8)
    return (rb << 8) | shamt


def decode(word: int):
    """word -> (op, rd, ra, rb, shamt, simm16). Pure-python mirror of the
    in-kernel decoders (used for disassembly)."""
    op = (word >> 26) & 0x3F
    rd = (word >> 21) & 0x1F
    ra = (word >> 16) & 0x1F
    imm = word & 0xFFFF
    simm = imm - ((imm & 0x8000) << 1)
    rb = (imm >> 8) & 0x1F
    sh = imm & 0xFF
    return op, rd, ra, rb, sh, simm


def validate(words) -> None:
    """Reject word streams with unknown opcodes (host-side, at program
    upload). Every executor runs unknown ops as NOPs — identically — but a
    program containing one is a bug worth catching at the boundary."""
    ops = (np.asarray(words, np.int64) >> 26) & 0x3F
    bad = ops[ops >= N_OPS]
    if bad.size:
        raise ValueError(f"unknown opcode(s) {sorted(set(bad.tolist()))}")


def disassemble(words) -> str:
    lines = []
    for w in np.asarray(words, np.int64):
        op, rd, ra, rb, sh, simm = decode(int(w))
        m = MNEMONIC.get(op, f"op{op}")
        if op == SPLAT:
            lines.append(f"{m} r{rd}, {simm / ONE:g}")
        elif op in (MOV, LDW, LDCAUSAL, LDACAUSAL, LDRATE, LDNOISE):
            src = f" r{ra}" if op == MOV else ""
            lines.append(f"{m} r{rd}{src}")
        elif op == LDMOD:
            lines.append(f"{m} r{rd}, slot{simm & 0xFF}")
        elif op == STW:
            lines.append(f"{m} r{ra}")
        elif op in (SHL, SHR):
            lines.append(f"{m} r{rd}, r{ra}, {sh}")
        elif op == MULF:
            lines.append(f"{m} r{rd}, r{ra}, r{rb}, >>{sh}")
        elif op == NOP:
            lines.append(m)
        else:
            lines.append(f"{m} r{rd}, r{ra}, r{rb}")
    return "\n".join(lines)
