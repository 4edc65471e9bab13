from repro_torch.kernels.synray.ops import synaptic_current  # noqa: F401
