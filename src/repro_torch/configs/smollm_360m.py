"""smollm-360m — llama-arch small dense LM.

[dense] 32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152
[hf:HuggingFaceTB/SmolLM-135M; hf]
"""
from repro_torch.config import ArchConfig, register

SMOLLM_360M = register(ArchConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab=49152,
    rope_theta=10000.0,
    tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-135M; hf",
))
