from repro_torch.kernels.census.ops import census  # noqa: F401
