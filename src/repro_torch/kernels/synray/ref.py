"""Plain PyTorch version of the synray kernel (the masked event x weight
product), time-major like the windows that feed it."""
import torch


def synaptic_current_ref(events_t, event_addr_t, weights, addresses):
    """events_t [T, ..., R] f32; event_addr_t [T, ..., R] int8;
    weights/addresses [..., R, C] int8 -> [T, ..., C] f32."""
    mask = addresses.unsqueeze(0) == event_addr_t.unsqueeze(-1)
    w_eff = weights.to(torch.float32).unsqueeze(0) * mask.to(torch.float32)
    return torch.einsum("t...r,t...rc->t...c",
                        events_t.to(torch.float32), w_eff)
