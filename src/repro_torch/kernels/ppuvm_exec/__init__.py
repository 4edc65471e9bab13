from repro_torch.kernels.ppuvm_exec.ops import run_program  # noqa: F401
