from repro_torch.kernels.ppu_update.ops import rstdp_update  # noqa: F401
