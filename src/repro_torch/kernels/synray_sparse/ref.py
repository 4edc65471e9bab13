"""Plain PyTorch version of the synray_sparse kernel (the twin of
``repro/kernels/synray_sparse/ref.py``): gather each step's fired weight
rows, apply the 6-bit address match per gathered record, and contract the
K record slots against the efficacies."""
import torch


def sparse_window_ref(rows_tk, addr_tk, eff_tk, weights, addresses):
    """rows_tk/addr_tk [N, T, K] int32; eff_tk [N, T, K] float32 (0 in
    empty slots); weights/addresses [N, R, C] int8 -> [N, T, C] float32.
    2-D record operands with 2-D stores are one instance."""
    if rows_tk.ndim == 2:
        return sparse_window_ref(rows_tk[None], addr_tk[None], eff_tk[None],
                                 weights[None], addresses[None])[0]
    n = torch.arange(rows_tk.shape[0], device=rows_tk.device
                     ).reshape(-1, 1, 1)
    rows = rows_tk.long()
    wg = weights[n, rows].to(torch.float32)                  # [N, T, K, C]
    match = (addresses[n, rows].to(torch.int32)
             == addr_tk.unsqueeze(-1)).to(torch.float32)
    return torch.einsum("ntk,ntkc->ntc", eff_tk, wg * match)
