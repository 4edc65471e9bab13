"""hymba-1.5b — hybrid: parallel attention + mamba heads per block.

[hybrid] 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16
[arXiv:2411.13676; hf]

Hymba details kept: 128 learnable meta tokens prepended; sliding-window
attention (1024) on all but 3 global-attention layers (first / middle /
last), which keeps the arch sub-quadratic for the 500k-context shape; each
block fuses a parallel SSM path (state 16) with the attention path by
averaging the two normed branch outputs.

Simplification (noted in DESIGN.md): the SSM heads use the SSD (mamba-2
style, scalar dt per head) formulation rather than mamba-1 selective scan —
behaviourally close, and it is the TPU/MXU-friendly matmul form. Cross-layer
KV sharing is not modeled.
"""
from repro_torch.config import ArchConfig, SSMConfig, register

HYMBA_15B = register(ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab=32001,
    rope_theta=10000.0,
    tie_embeddings=True,
    swa_window=1024,
    global_attn_layers=(0, 15, 31),
    n_meta_tokens=128,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=128, n_groups=1,
                  chunk=256),
    plasticity_observable="state",
    source="arXiv:2411.13676; hf",
))
