"""Configuration system (a copy of ``repro/config.py``).

Three config families:
  * ``ArchConfig``  — one per supported architecture (the 10 assigned archs,
    plus the paper's own BSS-2 machine model).
  * ``ShapeConfig`` — the assigned input shapes (train_4k / prefill_32k /
    decode_32k / long_500k).
  * ``MeshConfig``  — logical mesh + sharding-rule selection.

Configs are plain frozen dataclasses, hashable and comparable field for
field with the reference's (``tests/test_torch_lm_config.py``).
``HardwareConfig`` / ``HW`` is the port's own: an NVIDIA H100, not the
reference's TPU v5e model.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------

FAMILIES = ("dense", "moe", "vlm", "audio", "hybrid", "ssm", "neuromorphic")


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # DeepSeek-style: first k layers stay dense (with d_ff_dense_first).
    first_k_dense: int = 0
    d_ff_dense_first: int = 0
    router_jitter: float = 0.0


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 0
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256            # SSD chunk length
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # one of FAMILIES
    n_layers: int
    d_model: int
    n_heads: int                     # query heads (0 for attention-free)
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    norm_eps: float = 1e-5
    tie_embeddings: bool = True
    causal: bool = True              # False for encoder-only (hubert)
    source: str = ""                 # provenance tag [source; verified-tier]

    # MoE / SSM sub-configs (empty defaults for dense archs)
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)

    # hybrid (hymba): sliding-window attention + parallel SSM heads
    swa_window: int = 0              # 0 -> full attention
    global_attn_layers: Tuple[int, ...] = ()   # layers with full attention
    n_meta_tokens: int = 0           # hymba learnable prefix tokens

    # vlm: patch-embedding stub frontend
    vit_dim: int = 0
    n_patches: int = 0

    # audio: frame-embedding stub frontend
    frame_dim: int = 0

    # paper technique: hybrid-plasticity knobs (C1'); see repro/plasticity
    plasticity_bits: int = 6         # BSS-2 synaptic weight resolution
    plasticity_observable: str = "activity"   # activity | state (ssm)

    # distribution
    attn_shard: str = "cp"           # "cp" (context parallel) | "heads"
    remat: bool = True
    remat_policy: str = "dots"       # "dots" (save matmul outputs) | "full"

    # ---- derived -----------------------------------------------------------
    def __post_init__(self):
        assert self.family in FAMILIES, self.family
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def vocab_padded(self) -> int:
        """Vocab padded to a multiple of 128 (TP-divisible, MXU-aligned).

        Embedding/unembedding tables are allocated at this size; padded
        logit columns are masked to -inf everywhere (loss + serving)."""
        return ((self.vocab + 127) // 128) * 128 if self.vocab else 0

    @property
    def attention_free(self) -> bool:
        return self.n_heads == 0

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch supports >=500k context (SSM / hybrid w/ SWA)."""
        if self.family == "ssm":
            return True
        if self.family == "hybrid" and self.swa_window > 0:
            return True
        return False

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6*N*D)."""
        d, L = self.d_model, self.n_layers
        n = self.vocab * d                      # embedding (tied)
        if not self.tie_embeddings:
            n += self.vocab * d
        for i in range(L):
            n += self._layer_params(i)
        if self.vit_dim:
            n += self.vit_dim * d + d * d       # projector MLP
        if self.frame_dim:
            n += self.frame_dim * d
        n += self.n_meta_tokens * d
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        d, L = self.d_model, self.n_layers
        n = self.vocab * d
        if not self.tie_embeddings:
            n += self.vocab * d
        for i in range(L):
            n += self._layer_params(i, active_only=True)
        if self.vit_dim:
            n += self.vit_dim * d + d * d
        if self.frame_dim:
            n += self.frame_dim * d
        return n

    def _layer_params(self, i: int, active_only: bool = False) -> int:
        d = self.d_model
        n = 0
        if self.n_heads:
            hd = self.head_dim
            n += d * self.n_heads * hd          # wq
            n += 2 * d * self.n_kv_heads * hd   # wk, wv
            n += self.n_heads * hd * d          # wo
            if self.qkv_bias:
                n += (self.n_heads + 2 * self.n_kv_heads) * hd
        if self.family == "ssm" or (self.family == "hybrid"):
            n += self._ssm_layer_params()
        if self.moe.n_experts and i >= self.moe.first_k_dense:
            fe = self.moe.d_ff_expert
            per_expert = 3 * d * fe
            n += d * self.moe.n_experts         # router
            n += self.moe.n_shared_experts * per_expert
            if active_only:
                n += self.moe.top_k * per_expert
            else:
                n += self.moe.n_experts * per_expert
        elif self.moe.n_experts and i < self.moe.first_k_dense:
            n += 3 * d * self.moe.d_ff_dense_first
        elif self.d_ff:
            n += 3 * d * self.d_ff              # SwiGLU: w1, wg, w2
        n += 2 * d                              # norms
        return n

    def _ssm_layer_params(self) -> int:
        d = self.d_model
        di = d * self.ssm.expand
        nh = di // self.ssm.head_dim
        ng, ns = self.ssm.n_groups, self.ssm.d_state
        conv_dim = di + 2 * ng * ns
        n = d * (2 * di + 2 * ng * ns + nh)     # in_proj (z, x, B, C, dt)
        n += conv_dim * self.ssm.d_conv         # depthwise conv
        n += 2 * nh                             # A_log, D
        n += di                                 # gate norm
        n += di * d                             # out_proj
        return n

    # ---- reduced config for CPU smoke tests --------------------------------
    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for single-device smoke tests."""
        moe = self.moe
        if moe.n_experts:
            moe = replace(moe, n_experts=min(8, moe.n_experts),
                          top_k=min(2, moe.top_k), d_ff_expert=64,
                          n_shared_experts=min(1, moe.n_shared_experts),
                          first_k_dense=min(1, moe.first_k_dense),
                          d_ff_dense_first=96 if moe.first_k_dense else 0)
        ssm = self.ssm
        if ssm.d_state:
            ssm = replace(ssm, d_state=16, head_dim=16, chunk=16)
        n_kv = max(1, min(self.n_kv_heads, 2)) if self.n_heads else 0
        n_h = 0
        if self.n_heads:
            ratio = max(1, self.n_heads // max(self.n_kv_heads, 1))
            n_h = n_kv * min(ratio, 3)
        return replace(
            self,
            n_layers=2 if not self.global_attn_layers else 3,
            d_model=64, n_heads=n_h, n_kv_heads=n_kv, head_dim=16 if n_h else 0,
            d_ff=96 if self.d_ff else 0, vocab=503 if self.vocab else 0,
            moe=moe, ssm=ssm,
            swa_window=8 if self.swa_window else 0,
            global_attn_layers=(1,) if self.global_attn_layers else (),
            n_meta_tokens=4 if self.n_meta_tokens else 0,
            vit_dim=32 if self.vit_dim else 0,
            n_patches=4 if self.n_patches else 0,
            frame_dim=24 if self.frame_dim else 0,
        )


# ---------------------------------------------------------------------------
# Shape config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # "train" | "prefill" | "decode"

    def reduced(self) -> "ShapeConfig":
        return replace(self, seq_len=32, global_batch=2)


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def cell_applicable(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Skip rules for the 40-cell (arch x shape) matrix.

    Returns (runnable, reason-if-skipped).
    """
    if shape.kind == "decode" and arch.is_encoder_only:
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, "500k context needs sub-quadratic attention (full-attention arch)"
    return True, ""


# ---------------------------------------------------------------------------
# Mesh config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MeshConfig:
    multi_pod: bool = False

    @property
    def shape(self) -> Tuple[int, ...]:
        return (2, 16, 16) if self.multi_pod else (16, 16)

    @property
    def axes(self) -> Tuple[str, ...]:
        return ("pod", "data", "model") if self.multi_pod else ("data", "model")

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def data_axes(self) -> Tuple[str, ...]:
        """Mesh axes carrying the batch dimension."""
        return ("pod", "data") if self.multi_pod else ("data",)


# H100 hardware model used by the roofline analysis.
@dataclass(frozen=True)
class HardwareConfig:
    """One NVIDIA H100 SXM5 80 GB at 700 W, from NVIDIA's data sheet.

    ``peak_flops_bf16`` is the dense tensor-core rate, half of the sheet's
    1,979 TFLOP/s, which is quoted with sparsity; ``RooflineReport
    .t_compute`` divides every FLOP by it, as the reference divides by its
    chip's bf16 peak. ``peak_flops_fp32`` is float32 outside the tensor
    cores (what the hand-written kernels' bounds use).

    The collective model is NVLink 4 within a node: ``links`` links of
    ``link_bw`` bytes/s a direction (18 x 25 GB/s, 900 GB/s both ways).
    Across nodes a GPU has one 400 Gb/s NIC, 50 GB/s, so on the 16 x 16
    mesh over 32 nodes of eight cards ``t_collective`` is a lower bound.
    """
    peak_flops_bf16: float = 989e12     # per card, dense
    peak_flops_fp32: float = 67e12      # per card, outside the tensor cores
    hbm_bw: float = 3.35e12             # bytes/s per card
    link_bw: float = 25e9               # bytes/s per NVLink a direction
    links: int = 18                     # NVLink 4 links per card
    hbm_bytes: int = 80 * 10**9         # 80 GB


HW = HardwareConfig()

# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all():
    from repro_torch import configs as _configs  # noqa: F401  (side-effect registry)


ASSIGNED_ARCHS = (
    "smollm-360m", "minitron-4b", "qwen1.5-0.5b", "phi4-mini-3.8b",
    "internvl2-2b", "moonshot-v1-16b-a3b", "llama4-scout-17b-a16e",
    "hubert-xlarge", "hymba-1.5b", "mamba2-130m",
)
