from repro_torch.kernels.stp_scan.ops import stp_scan  # noqa: F401
