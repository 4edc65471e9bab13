"""hubert-xlarge — encoder-only audio transformer (w2v2 arch).

[audio] 48L d_model=1280 16H (GQA kv=16) d_ff=5120 vocab=504
[arXiv:2106.07447; unverified]

Encoder-only: bidirectional attention, no decode shapes. The conv waveform
frontend is a STUB: ``input_specs()`` supplies precomputed frame embeddings
(dim 512, the w2v2 conv-stack output width). Training objective: masked
unit prediction over the 504-unit codebook.
"""
from repro_torch.config import ArchConfig, register

HUBERT_XLARGE = register(ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab=504,
    rope_theta=0.0,      # absolute (sinusoidal) positions added at the frontend
    causal=False,
    tie_embeddings=False,
    frame_dim=512,
    source="arXiv:2106.07447; unverified",
))
