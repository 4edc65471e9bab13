"""qwen1.5-0.5b — dense LM with QKV bias.

[dense] 24L d_model=1024 16H (GQA kv=16) d_ff=2816 vocab=151936
[hf:Qwen/Qwen1.5-0.5B; hf]
"""
from repro_torch.config import ArchConfig, register

QWEN15_05B = register(ArchConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=2816,
    vocab=151936,
    rope_theta=1000000.0,
    qkv_bias=True,
    tie_embeddings=True,
    source="hf:Qwen/Qwen1.5-0.5B; hf",
))
