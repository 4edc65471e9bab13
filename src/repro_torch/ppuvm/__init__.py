"""PPU-VM: a SIMD fixed-point instruction-set emulator for the plasticity
processing unit — learning rules become uploadable programs (paper §2.2,
§3.1, §5).

  isa        numeric model, opcode table, encoding (a copy of the
             reference's)
  asm        assembler -> dense int32 program words (a copy)
  programs   R-STDP / STDP / homeostasis / the §5 signed dw rule written
             in the ISA (a copy)
  interp     ``run_program`` (plain PyTorch version on the CPU, the
             ``ppuvm_exec`` CUDA kernel on the card) and the independent
             NumPy interpreter ``run_program_np``
"""
from repro_torch.ppuvm import asm, interp, isa, programs  # noqa: F401
