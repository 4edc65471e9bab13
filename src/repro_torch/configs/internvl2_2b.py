"""internvl2-2b — VLM: InternViT frontend (stub) + InternLM2 backbone.

[vlm] 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553
[arXiv:2404.16821; hf]

The modality frontend is a STUB: ``input_specs()`` supplies precomputed patch
embeddings at vit_dim=1024 (InternViT-300M output, 256 tokens after pixel
shuffle); the in-model projector (2-layer MLP) maps them into the backbone.
"""
from repro_torch.config import ArchConfig, register

INTERNVL2_2B = register(ArchConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=92553,
    rope_theta=1000000.0,
    tie_embeddings=True,
    vit_dim=1024,
    n_patches=256,
    source="arXiv:2404.16821; hf",
))
