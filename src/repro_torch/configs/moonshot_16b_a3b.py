"""moonshot-v1-16b-a3b — kimi/Moonlight DeepSeek-style fine-grained MoE.

[moe] 48L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=163840, MoE 64e top-6
[hf:moonshotai/Moonlight-16B-A3B; hf]

DeepSeek-V3-style details kept: 2 shared experts, first layer dense
(d_ff 11264 = 8 x 1408).
"""
from repro_torch.config import ArchConfig, MoEConfig, register

MOONSHOT_16B_A3B = register(ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=0,                      # all FFN capacity lives in the MoE config
    vocab=163840,
    rope_theta=50000.0,
    tie_embeddings=True,
    moe=MoEConfig(
        n_experts=64,
        top_k=6,
        d_ff_expert=1408,
        n_shared_experts=2,
        capacity_factor=1.25,
        first_k_dense=1,
        d_ff_dense_first=11264,
    ),
    source="hf:moonshotai/Moonlight-16B-A3B; hf",
))
