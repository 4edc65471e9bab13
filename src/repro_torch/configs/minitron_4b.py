"""minitron-4b — pruned Nemotron dense LM.

[dense] 32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000
[arXiv:2407.14679; hf]
"""
from repro_torch.config import ArchConfig, register

MINITRON_4B = register(ArchConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab=256000,
    rope_theta=10000.0,
    tie_embeddings=True,
    source="arXiv:2407.14679; hf",
))
