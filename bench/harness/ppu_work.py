"""The work of the port's ``ppuvm_exec`` kernel, as the benchmark counts
it: a frozen copy of ``repro_torch.kernels.ppuvm_exec.ops.work()``
(``bench/test_bench_ppu.py`` ties the two at the cell's shape). Returns
``(operations, bytes)``: every input byte read once and every output
byte written once, one instruction a word and lane.
"""
from __future__ import annotations

# the words of the §5 rule's program, ``signed_dw_program``
SIGNED_DW_WORDS = 19


def ppuvm_exec(N: int, R: int, C: int, n_words: int, n_planes: int,
               n_mod: int, w_bytes: int = 1):
    """One program's run over [N, R, C] lanes: each lane's weight
    (``w_bytes``) and its ``n_planes`` int32 planes read, the int32 weight
    and the 8 int32 registers written; the rate counters and the ``n_mod``
    modulator slots ([N, C] each) and the words read."""
    lanes = N * R * C
    return (float(n_words * lanes),
            float(lanes * (w_bytes + 4 * (n_planes + 1 + 8))
                  + N * C * 4 * (1 + n_mod) + 4 * n_words))
