"""Shared layer primitives: norms, RoPE, SwiGLU MLP, embeddings and the
cross-entropy helpers (``repro/models/layers.py``)."""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.parallel.sharding import (Ax, ParamDecl, ShardingCtx,
                                           implicit_replication)


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


def pad_dim1(x, before: int, after: int):
    """``x`` with ``before`` / ``after`` zero rows around dim 1, as a
    concatenation (DTensor's ``F.pad`` has given a wrong output shape when
    only the pad widths changed between calls)."""
    shape = list(x.shape)
    parts = []
    for n in (before, after):
        shape[1] = n
        parts.append(torch.zeros(shape, dtype=x.dtype, device=x.device)
                     if n else None)
    with implicit_replication():
        return torch.cat([p for p in (parts[0], x, parts[1])
                          if p is not None], dim=1)


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


def _swiglu(x, wg, w1, w2):
    return ((F.silu(x @ wg) * (x @ w1)) @ w2,)


def mlp(x, p, ctx: ShardingCtx):
    """SwiGLU. Where the sequence is split over ``model`` it runs on each
    rank's positions with the three weights gathered, not as Megatron's
    sequence gather, tensor-parallel product and reduce-scatter: at the
    production shapes a layer's weights (3 d f) move less than its
    activations would (2 (b / dp) s d each way)."""
    if ctx.seq_split(x.shape):
        return ctx.split_region(_swiglu, x.shape, ("seq",) + ("whole",) * 3,
                                ("seq",))(x, *(ctx.cast(p[k]) for k in
                                               ("wg", "w1", "w2")))[0]
    h = F.silu(x @ ctx.cast(p["wg"])) * (x @ ctx.cast(p["w1"]))
    return h @ ctx.cast(p["w2"])


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_decl(vocab: int, d: int) -> ParamDecl:
    return ParamDecl((vocab, d), (Ax.VOCAB, Ax.EMBED), init="embed")


def embed_lookup(tokens, emb, ctx: ShardingCtx):
    # under a mesh the ids whole on every rank: DTensor (torch 2.11) takes
    # no lookup backward on batch-sharded ids (it asks for a normalised
    # shard dim; ``tests/_torch_lm_mesh.py`` part ``grads``)
    tokens = ctx.constrain(tokens, *(None,) * tokens.ndim)
    return ctx.cast(emb)[tokens]


def unembed(x, emb, ctx: ShardingCtx, real_vocab: int = 0):
    """Logits against the (tied) embedding; the weight operand is held
    vocab-sharded, embed-replicated, as the reference constrains it."""
    emb_c = ctx.constrain(ctx.cast(emb), Ax.VOCAB_ACT, None)
    logits = x @ emb_c.T
    axes = (Ax.BATCH,) + (Ax.NONE,) * (x.ndim - 2) + (Ax.VOCAB_ACT,)
    logits = ctx.constrain(logits, *axes)
    return mask_vocab_pad(logits, real_vocab)


def mask_vocab_pad(logits, real_vocab: int):
    """-1e30 on the padded vocab columns (vocab_padded > vocab)."""
    if real_vocab and logits.shape[-1] > real_vocab:
        col = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(col < real_vocab, logits, -1e30)
    return logits


# ---------------------------------------------------------------------------
# Cross entropy
# ---------------------------------------------------------------------------

def _nll(logits, labels):
    """Per-token negative log-likelihood of fp32 ``logits`` [..., V]: the
    reference's log-sum-exp with the max held constant (``stop_gradient``)
    and the gold logit gathered."""
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m[..., 0]
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return lse - gold


def lm_loss_chunked(x, emb_or_head, labels, ctx: ShardingCtx, *,
                    tied: bool, mask=None, max_chunk_tokens: int = 1 << 18,
                    real_vocab: int = 0, prefix: int = 0):
    """Cross entropy with the unembed fused per batch chunk
    (``_nll_block``).

    ``x`` [b, prefix + s, d] holds ``prefix`` leading positions without
    labels (meta tokens, image patches); ``labels`` and ``mask`` are
    [b, s]. The loop over batch chunks bounds the peak to one chunk's
    [cb, S, V] fp32 logits: ``n_chunks`` is the largest divisor of the
    batch not above tokens / ``max_chunk_tokens`` (at least 1).

    Under a device mesh each rank takes its own tokens' terms (its batch
    rows, and its positions where the sequence is split over ``model``)
    with the unembed weight gathered, in a ``split_region``, and the sum
    and the count are summed over the mesh: the mean over the global
    token count. The logits' vocab stays whole: on torch 2.11, DTensor's
    gradient of a ``log`` of a sum over a vocab sharded on one mesh dim,
    with the batch sharded on the other, is wrong
    (``tests/_torch_lm_mesh.py``, part ``ops``).
    """
    extra = () if mask is None else (mask,)
    fn = functools.partial(_nll_block, tied=tied,
                           max_chunk_tokens=max_chunk_tokens,
                           real_vocab=real_vocab)
    w = ctx.cast(emb_or_head)
    if not ctx.places:
        total, denom = fn(x[:, prefix:], w, labels, *extra, offset=0)
        return total / torch.clamp(denom, min=1.0)
    first = 0
    if ctx.seq_split(x.shape):
        first = ctx.model_rank * (x.shape[1] // ctx.model_size)
    total, denom = ctx.split_region(
        functools.partial(fn, offset=first - prefix), x.shape,
        ("seq", "whole") + ("batch",) * (1 + len(extra)), ("sum", "sum"))(
        x, w, labels, *extra)
    whole = ctx.act_sharding((), ())
    total, denom = (t.redistribute(ctx.mesh, whole) for t in (total, denom))
    return total / torch.clamp(denom, min=1.0)


def _nll_block(x, w, labels, *mask, tied: bool, offset: int,
               max_chunk_tokens: int, real_vocab: int):
    """The summed negative log-likelihood and label count of ``x``
    [b, s_x, d] at positions ``offset`` on among the labels (negative
    ones, the prefix, take none), ``labels`` (and ``mask``) [b, s], ``w``
    the whole unembed weight."""
    b, s_x, _ = x.shape
    idx = torch.arange(s_x, device=x.device) + offset
    at = idx.clamp(min=0)
    wt = (idx >= 0).float()[None].expand(b, s_x)
    if mask:
        wt = wt * mask[0][:, at].float()
    lab = labels[:, at]
    n_chunks = max(1, (b * s_x) // max_chunk_tokens)
    while b % n_chunks:
        n_chunks -= 1
    cb = b // n_chunks
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_chunks):
        xc = x[i * cb:(i + 1) * cb]
        logits = mask_vocab_pad(xc @ (w.T if tied else w), real_vocab)
        nll = _nll(logits.float(), lab[i * cb:(i + 1) * cb])
        total = total + torch.sum(nll * wt[i * cb:(i + 1) * cb])
    return total, torch.sum(wt)


def softmax_xent(logits, labels, mask=None):
    """Cross entropy over the last dim, masked mean where ``mask`` is
    given."""
    nll = _nll(logits.float(), labels)
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
