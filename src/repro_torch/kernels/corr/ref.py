"""Plain PyTorch version of the corr kernel: the per-step update of
``repro_torch.core.correlation`` replayed over the window (the twin of
``repro/kernels/corr/ref.py``), with the decay ``lam`` given directly."""
import torch


def correlation_window_ref(pre_t, post_t, tp0, tq0, ac0, aa0, *, lam: float,
                           sat: float = 1023.0):
    """pre_t [T, ..., R]; post_t [T, ..., C]; tp0 [..., R]; tq0 [..., C];
    ac0/aa0 [..., R, C]. Returns (a_causal, a_acausal, tp, tq)."""
    tp, tq, ac, aa = tp0, tq0, ac0, aa0
    for t in range(pre_t.shape[0]):
        p, q = pre_t[t], post_t[t]
        tp = tp * lam + p
        tq = tq * lam + q
        ac = torch.clamp_max(ac + tp.unsqueeze(-1) * q.unsqueeze(-2), sat)
        aa = torch.clamp_max(aa + p.unsqueeze(-1) * tq.unsqueeze(-2), sat)
    return ac, aa, tp, tq
