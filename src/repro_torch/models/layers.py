"""Shared layer primitives: norms, RoPE, SwiGLU MLP, embeddings
(``repro/models/layers.py``; the loss helpers come with training)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.parallel.sharding import Ax, ParamDecl, ShardingCtx


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_decl(d: int) -> ParamDecl:
    return ParamDecl((d,), (None,), init="ones")


def rmsnorm(x, w, eps: float = 1e-5):
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * w.float()).to(dt)


def rmsnorm_gated(x, z, w, eps: float = 1e-5):
    """Mamba-2 gated RMSNorm: norm(x * silu(z)) * w."""
    dt = x.dtype
    xf = x.float() * F.silu(z.float())
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * w.float()).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: [..., seq, heads, head_dim]; positions broadcastable to [..., seq]."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # [hd/2]
    ang = positions[..., None].float() * freqs              # [..., seq, hd/2]
    cos = torch.cos(ang)[..., None, :]                      # [..., seq, 1, hd/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def mlp_decls(d: int, f: int) -> dict:
    return dict(
        wg=ParamDecl((d, f), (Ax.EMBED, Ax.FF)),
        w1=ParamDecl((d, f), (Ax.EMBED, Ax.FF)),
        w2=ParamDecl((f, d), (Ax.FF, Ax.EMBED)),
    )


def mlp(x, p, ctx: ShardingCtx):
    h = F.silu(x @ ctx.cast(p["wg"])) * (x @ ctx.cast(p["w1"]))
    return h @ ctx.cast(p["w2"])


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_decl(vocab: int, d: int) -> ParamDecl:
    return ParamDecl((vocab, d), (Ax.VOCAB, Ax.EMBED), init="embed")


def embed_lookup(tokens, emb, ctx: ShardingCtx):
    return ctx.cast(emb)[tokens]


def unembed(x, emb, ctx: ShardingCtx, real_vocab: int = 0):
    """Logits against the (tied) embedding."""
    logits = x @ ctx.cast(emb).T
    return mask_vocab_pad(logits, real_vocab)


def mask_vocab_pad(logits, real_vocab: int):
    """-1e30 on the padded vocab columns (vocab_padded > vocab)."""
    if real_vocab and logits.shape[-1] > real_vocab:
        logits = logits.clone()
        logits[..., real_vocab:] = -1e30
    return logits
