from repro_torch.kernels.corr.ops import correlation_window  # noqa: F401
