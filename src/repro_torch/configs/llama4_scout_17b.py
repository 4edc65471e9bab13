"""llama4-scout-17b-a16e — MoE with top-1 routing + shared expert.

[moe] 48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16e top-1
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""
from repro_torch.config import ArchConfig, MoEConfig, register

LLAMA4_SCOUT_17B = register(ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=0,
    vocab=202048,
    rope_theta=500000.0,
    tie_embeddings=True,
    moe=MoEConfig(
        n_experts=16,
        top_k=1,
        d_ff_expert=8192,
        n_shared_experts=1,
        capacity_factor=1.25,
    ),
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
))
