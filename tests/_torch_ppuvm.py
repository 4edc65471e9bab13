"""The PPU-VM's deterministic test corpus, built with the port's assembler
and numpy only (no JAX), for the port's tests and ``chip_smoke.py``.

Not collected by pytest (no ``test_`` prefix). ``gen_program`` /
``gen_operands`` / ``pad`` are the generators of
``tests/test_ppuvm_fuzz.py`` over ``repro_torch.ppuvm`` (tests/
test_torch_ppuvm.py holds them equal to the originals, seed by seed);
``edge_program`` is that file's saturation program;
``canonical_program`` is ``tests/test_ppuvm_golden.py``'s playback program
of one rule, over ``repro_torch.verif.playback``, and ``load_trace`` reads
its golden trace.
"""
import dataclasses
import os

import numpy as np

from repro_torch.ppuvm import isa, programs
from repro_torch.ppuvm.asm import Asm

R, C = 8, 8
PAD_LEN = 40
N_PROGRAMS = 200
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "golden")

EDGE_SPLATS = (1.0, -1.0, 1 / isa.ONE, -1 / isa.ONE, 127.996, -128.0,
               127.0, -127.0, 64.0, -64.0, 0.0)


def gen_program(rng: np.random.RandomState, max_len: int = 32) -> np.ndarray:
    """One random valid program: bounded length, every opcode drawable,
    random register/slot/shift operands, edge-value constants mixed in."""
    a = Asm()
    n = int(rng.randint(1, max_len + 1))
    ops = rng.randint(0, isa.N_OPS, n)
    for op in ops:
        rd, ra, rb = (int(x) for x in rng.randint(0, isa.N_REGS, 3))
        sh = int(rng.randint(0, 20))          # beyond the clamp on purpose
        if op == isa.SPLAT:
            if rng.rand() < 0.5:
                val = float(EDGE_SPLATS[rng.randint(len(EDGE_SPLATS))])
            else:
                val = float(rng.uniform(-130, 130))
            a.splat(rd, val)
        elif op == isa.LDMOD:
            a.ldmod(rd, int(rng.randint(0, 4)))   # incl. out-of-range slots
        elif op == isa.STW:
            a.stw(ra)
        elif op in (isa.MOV,):
            a.mov(rd, ra)
        elif op in (isa.LDW, isa.LDCAUSAL, isa.LDACAUSAL, isa.LDRATE,
                    isa.LDNOISE):
            a._emit(op, rd)
        elif op in (isa.SHL, isa.SHR):
            a._emit(op, rd, ra, isa.alu_imm(0, sh))
        elif op == isa.NOP:
            a.nop()
        else:                                 # 3-reg ALU (+ MULF shift)
            a._emit(op, rd, ra, isa.alu_imm(rb, sh if op == isa.MULF else 0))
    words = a.build()
    isa.validate(words)
    assert words.shape[0] <= PAD_LEN
    return words


def gen_operands(rng: np.random.RandomState, edge: bool = False) -> dict:
    """Random operand planes; ``edge=True`` pins them to the saturation
    corpus (weight rails 0/63, CADC rails 0/255, rate overflow, int16-rail
    mod and noise)."""
    if edge:
        w_pool = np.array([0, 63, 1, 62], np.int32)
        q_pool = np.array([0, 255, 1, 254], np.int32)
        return dict(
            weights=w_pool[rng.randint(0, 4, (R, C))],
            qc=q_pool[rng.randint(0, 4, (R, C))],
            qa=q_pool[rng.randint(0, 4, (R, C))],
            rates=np.array([0.0, 1.0, 127.0, 1000.0] * (C // 4),
                           np.float32)[:C],
            mod=np.stack([np.full(C, isa.I16MAX, np.int32),
                          np.full(C, isa.I16MIN, np.int32)]),
            noise=np.where(rng.rand(R, C) < 0.5, isa.I16MAX,
                           isa.I16MIN).astype(np.int32),
        )
    return dict(
        weights=rng.randint(0, 64, (R, C)).astype(np.int32),
        qc=rng.randint(0, 256, (R, C)).astype(np.int32),
        qa=rng.randint(0, 256, (R, C)).astype(np.int32),
        rates=rng.randint(0, 300, (C,)).astype(np.float32),
        mod=isa.to_fixed(rng.uniform(-2, 2, (2, C))),
        noise=isa.to_fixed(rng.uniform(-128, 128, (R, C))),
    )


def pad(words: np.ndarray) -> np.ndarray:
    """NOP-pad to the next multiple of PAD_LEN (NOP is the all-zero
    word)."""
    n = max(PAD_LEN, -(-int(words.shape[0]) // PAD_LEN) * PAD_LEN)
    out = np.zeros(n, np.int32)
    out[:words.shape[0]] = words
    return out


def corpus():
    """The fuzz corpus: ``(seed, padded words, operands)`` for each of the
    200 seeds, every fifth on the edge operands."""
    for seed in range(N_PROGRAMS):
        rng = np.random.RandomState(seed)
        words = gen_program(rng)
        yield seed, pad(words), gen_operands(rng, edge=(seed % 5 == 0))


def edge_program() -> np.ndarray:
    """Every edge constant splatted, summed against itself, multiplied at
    shift 0 and 16, shifted to the clamp, added to a weight and stored."""
    a = Asm()
    for i, v in enumerate((127.996, -128.0, 1.0, -1.0, 1 / isa.ONE)):
        a.splat(i % isa.N_REGS, v)
    a.add(0, 0, 0)
    a.sub(1, 1, 0)
    a.mulf(2, 0, 1, 0)
    a.mulf(3, 4, 4, 16)
    a.shl(4, 0, 15)
    a.ldw(5)
    a.add(5, 5, 0)
    a.stw(5)
    return a.build()


def unknown_opcode_program() -> np.ndarray:
    """Words with opcodes past the table (25, and 63 with every field
    bit set: a negative int32 word) between a splat and a store; every
    executor runs them as NOP."""
    a = Asm()
    a.splat(0, 5.0)
    a.words.append(isa.encode(25, 1, 0, 0))
    a.words.append(isa.encode(63, 31, 31, 0xFFFF))
    a.stw(0)
    return np.asarray(np.asarray(a.words, np.int64).astype(np.uint32)
                      .view(np.int32))


def shipped_programs():
    """The rules as shipped, at the parameters the reference's tests use."""
    return {
        "rstdp": programs.rstdp_program(eta=0.5),
        "stdp": programs.stdp_program(),
        "homeostasis": programs.homeostasis_program(target_rate=4.0),
        "signed_dw": programs.signed_dw_program(
            eta=16.0, eta_homeo=0.4, fire_thresh=1.0),
    }


def prefixed_operands(rng: np.random.RandomState, shape) -> dict:
    """Random operands at ``shape`` = [*prefix, R, C] (mod [2, *prefix,
    C]), as ``test_pallas_multi_tile_and_batched_prefix`` draws them."""
    c = shape[-1]
    return dict(
        weights=rng.randint(0, 64, shape).astype(np.int32),
        qc=rng.randint(0, 256, shape).astype(np.int32),
        qa=rng.randint(0, 256, shape).astype(np.int32),
        rates=rng.randint(0, 300, (*shape[:-2], c)).astype(np.float32),
        mod=isa.to_fixed(rng.uniform(-2, 2, (2, *shape[:-2], c))),
        noise=isa.to_fixed(rng.uniform(-128, 128, shape)),
    )


# ---------------------------------------------------------------------------
# golden playback programs
# ---------------------------------------------------------------------------

GOLDEN_RULES = {
    "rstdp": lambda: programs.rstdp_program(eta=0.5),
    "stdp": lambda: programs.stdp_program(eta_plus=0.8, eta_minus=0.9),
    "homeostasis": lambda: programs.homeostasis_program(target_rate=4.0),
}
GOLDEN_ROWS = GOLDEN_COLS = 8


def golden_cfg():
    """The golden programs' chip: the reduced config cut to 8 x 8."""
    from repro_torch.configs.bss2 import BSS2
    return dataclasses.replace(BSS2.reduced(), n_rows=GOLDEN_ROWS,
                               n_cols=GOLDEN_COLS)


def canonical_program(rule: str, seed: int = 17):
    """The canonical playback program of one rule: a deterministic event
    stream, two PPU_RUNs (one with a noise plane, one without), weight and
    rate read-backs between them. ``seed`` draws the modulator and noise
    planes: 17 for the golden traces, 0 for tests/test_ppuvm.py's
    ``TestPlaybackCosim._program``."""
    from repro_torch.verif import playback as pb
    words = GOLDEN_RULES[rule]()
    rng = np.random.RandomState(seed)
    r, c = GOLDEN_ROWS, GOLDEN_COLS
    w = np.full((r, c), 50, np.int8)
    addr = np.zeros((r, c), np.int8)
    ev = np.zeros((100, r), np.float32)
    ev[10] = 1.0
    ev[55] = 1.0
    ev[80, ::2] = 1.0
    mod = rng.uniform(-1, 1, (2, c)).astype(np.float32)
    noise = (0.3 * rng.randn(r, c)).astype(np.float32)
    return [
        pb.write_weights(w),
        pb.write_addresses(addr),
        pb.write_ppu_program(words),
        pb.inject(ev),
        pb.ppu_run(mod=mod, noise=noise),
        pb.read_weights(),
        pb.run(40),
        pb.ppu_run(mod=mod),
        pb.read_weights(),
        pb.read_rates(),
    ]


def load_trace(rule: str):
    """The golden trace ``tests/golden/playback_<rule>.npz``."""
    path = os.path.join(GOLDEN_DIR, f"playback_{rule}.npz")
    with np.load(path) as z:
        n = int(z["n"])
        return [(int(z[f"t_{i}"]), str(z[f"kind_{i}"]), z[f"val_{i}"])
                for i in range(n)]
