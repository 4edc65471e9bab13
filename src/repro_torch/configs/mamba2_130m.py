"""mamba2-130m — attention-free SSM (SSD, state-space duality).

[ssm] 24L d_model=768 (attn-free) d_ff=0 vocab=50280, ssm_state=128
[arXiv:2405.21060; unverified]

Standard mamba2 block: in_proj -> (z, xBC, dt); causal depthwise conv (k=4)
on xBC; SSD chunked recurrence (headdim 64 => 24 heads at expand=2); gated
RMSNorm; out_proj. No attention, no MLP (d_ff=0).
"""
from repro_torch.config import ArchConfig, SSMConfig, register

MAMBA2_130M = register(ArchConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk=256),
    plasticity_observable="state",
    source="arXiv:2405.21060; unverified",
))
