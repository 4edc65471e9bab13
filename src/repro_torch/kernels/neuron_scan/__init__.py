from repro_torch.kernels.neuron_scan.ops import neuron_window  # noqa: F401
