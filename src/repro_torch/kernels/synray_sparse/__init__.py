from repro_torch.kernels.synray_sparse.ops import (  # noqa: F401
    sparse_window, synaptic_current_sparse)
