"""phi4-mini-3.8b — dense LM, RoPE + SwiGLU + GQA.

[dense] 32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064
[arXiv:2412.08905; hf]
"""
from repro_torch.config import ArchConfig, register

PHI4_MINI_38B = register(ArchConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=200064,
    rope_theta=10000.0,
    tie_embeddings=True,
    source="arXiv:2412.08905; hf",
))
