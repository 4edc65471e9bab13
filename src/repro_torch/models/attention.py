"""Attention: GQA (``repro/models/attention.py``).

Three execution paths, as in the reference:

  * ``attention_prefill`` — one block of plain softmax when the whole KV
    fits in ``kv_block``, else an online softmax over KV blocks (a Python
    loop, one block of scores at a time).
  * ``attention_swa_blocked`` — exact banded sliding-window attention via
    the two-block trick (each w-sized q block attends to its own and the
    previous KV block).
  * ``attention_decode`` — one query token against the KV cache.

Where the sequence is split over ``model`` (``ShardingCtx.seq_split``)
a prefill is context-parallel, in two ``split_region``s: the q/k/v
projections and RoPE on each rank's positions (the weights gathered,
the head dims whole), then k and v gathered over ``model`` at the edge
and each rank's queries attending to every key (``q_offset``: its first
position), with the output projection local.

Scores and softmax statistics are fp32 (the contractions run on fp32
operands, which is what the reference's ``preferred_element_type=f32``
computes); the p@v contraction takes p in the compute dtype. Matrix
products are ``torch.einsum`` / ``@``: the reference computes them
outside any kernel too.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.config import ArchConfig
from repro_torch.models.layers import apply_rope
from repro_torch.parallel.sharding import Ax, ParamDecl, ShardingCtx

NEG_INF = -1e30


def _ein(eq, a, b):
    """``einsum`` accumulated and returned in fp32 (the reference's
    ``preferred_element_type=jnp.float32``)."""
    return torch.einsum(eq, a.float(), b.float())


def attn_decls(arch: ArchConfig) -> dict:
    d, h, kvh, hd = arch.d_model, arch.n_heads, arch.n_kv_heads, arch.head_dim
    decls = dict(
        wq=ParamDecl((d, h * hd), (Ax.EMBED, Ax.HEADS_OUT)),
        wk=ParamDecl((d, kvh * hd), (Ax.EMBED, Ax.HEADS_OUT)),
        wv=ParamDecl((d, kvh * hd), (Ax.EMBED, Ax.HEADS_OUT)),
        wo=ParamDecl((h * hd, d), (Ax.HEADS_OUT, Ax.EMBED)),
    )
    if arch.qkv_bias:
        decls.update(
            bq=ParamDecl((h * hd,), (None,), init="zeros"),
            bk=ParamDecl((kvh * hd,), (None,), init="zeros"),
            bv=ParamDecl((kvh * hd,), (None,), init="zeros"),
        )
    return decls


def _qkv(x, p, arch: ArchConfig, ctx: ShardingCtx, positions):
    b, s = x.shape[0], x.shape[1]
    h, kvh, hd = arch.n_heads, arch.n_kv_heads, arch.head_dim
    q = x @ ctx.cast(p["wq"])
    k = x @ ctx.cast(p["wk"])
    v = x @ ctx.cast(p["wv"])
    if arch.qkv_bias:
        q = q + ctx.cast(p["bq"])
        k = k + ctx.cast(p["bk"])
        v = v + ctx.cast(p["bv"])
    # the projections' head dims whole before they are split into heads (a
    # head count the model axis does not divide cannot be split sharded);
    # the layout the reference constrains to below
    q = ctx.constrain(q, Ax.BATCH, Ax.SEQ, None)
    k = ctx.constrain(k, Ax.BATCH, Ax.SEQ, None)
    v = ctx.constrain(v, Ax.BATCH, Ax.SEQ, None)
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kvh, hd)
    v = v.reshape(b, s, kvh, hd)
    if arch.rope_theta:
        q = apply_rope(q, positions, arch.rope_theta)
        k = apply_rope(k, positions, arch.rope_theta)
    # context-parallel layout: sequence over `model` (a split sequence
    # comes here as plain local blocks, ``_attn_split``)
    q = ctx.constrain(q, Ax.BATCH, Ax.SEQ, None, None)
    k = ctx.constrain(k, Ax.BATCH, Ax.SEQ, None, None)
    v = ctx.constrain(v, Ax.BATCH, Ax.SEQ, None, None)
    return q, k, v


def _mask(qpos, kpos, causal: bool, window: int):
    mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    return mask


def attention_prefill(q, k, v, *, causal: bool, window: int, ctx: ShardingCtx,
                      kv_block: int = 8192, q_offset: int = 0):
    """Plain or online-softmax attention over KV blocks.

    q: [b, sq, h, hd]; k/v: [b, skv, kvh, hd]. Returns [b, sq, h, hd].
    ``q_offset``: the position of q[:, 0] among the keys' (a rank's first
    position where the queries are split over ``model``).
    """
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, hd)
    scale = 1.0 / (hd ** 0.5)

    kv_block = min(kv_block, skv)
    n_blocks = (skv + kv_block - 1) // kv_block
    qpos = torch.arange(sq, device=q.device) + q_offset

    if n_blocks == 1:
        sc = _ein("bqkgd,btkd->bkgqt", qg, k) * scale
        # the reference's q-dim site (the sequence whole on a device mesh)
        sc = ctx.constrain(sc, Ax.BATCH, None, None, Ax.SEQ, None)
        mask = _mask(qpos, torch.arange(skv, device=q.device), causal, window)
        sc = torch.where(mask[None, None, None], sc, NEG_INF)
        p = torch.softmax(sc, dim=-1)
        out = _ein("bkgqt,btkd->bqkgd", p.to(q.dtype), v)
        out = ctx.constrain(out, Ax.BATCH, Ax.SEQ, None, None, None)
        return out.reshape(b, sq, h, hd).to(q.dtype)

    m = torch.full((b, kvh, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, kvh, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, kvh, g, hd), dtype=torch.float32,
                      device=q.device)
    for j in range(n_blocks):
        lo = j * kv_block
        hi = min(lo + kv_block, skv)
        s_ij = _ein("bqkgd,btkd->bkgqt", qg, k[:, lo:hi]) * scale
        s_ij = ctx.constrain(s_ij, Ax.BATCH, None, None, Ax.SEQ, None)
        mask = _mask(qpos, torch.arange(lo, hi, device=q.device), causal,
                     window)
        s_ij = torch.where(mask[None, None, None], s_ij, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s_ij, dim=-1))
        p = torch.exp(s_ij - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + torch.sum(p, dim=-1)
        pv = _ein("bkgqt,btkd->bqkgd", p.to(q.dtype), v[:, lo:hi])
        pv = ctx.constrain(pv, Ax.BATCH, Ax.SEQ, None, None, None)
        acc = acc * alpha.permute(0, 3, 1, 2)[..., None] + pv
        m = m_new

    lt = l.permute(0, 3, 1, 2)[..., None]
    out = acc / torch.clamp(lt, min=1e-30)
    return out.reshape(b, sq, h, hd).to(q.dtype)


def attention_swa_blocked(q, k, v, *, window: int, ctx: ShardingCtx,
                          q_offset: int = 0):
    """Exact sliding-window attention via the two-block band trick.

    q: [b, sq, h, hd] at positions ``q_offset`` on; k/v: [b, s, kvh, hd]
    from position 0 (sq == s without an offset). ``sq``, ``s`` and
    ``q_offset`` are multiples of the window. Each w-block of queries
    attends to its own and the previous KV block (covers the full causal
    window); the block before a rank's first is the previous rank's.
    """
    b, sq, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    w = window
    assert sq % w == 0 and s % w == 0 and q_offset % w == 0
    nb, n0 = sq // w, q_offset // w
    scale = 1.0 / (hd ** 0.5)

    qb = q.reshape(b, nb, w, kvh, g, hd)

    def pairs(t):
        """[b, nb, 2w, kvh, hd]: each q block's previous and own block
        (zeros before position 0)."""
        tb = t.reshape(b, s // w, w, kvh, hd)
        tb = torch.cat([torch.zeros_like(tb[:, :1]), tb], 1)
        return torch.cat([tb[:, n0:n0 + nb], tb[:, n0 + 1:n0 + 1 + nb]], 2)
    kcat, vcat = pairs(k), pairs(v)
    sc = _ein("bnqkgd,bntkd->bnkgqt", qb, kcat) * scale
    sc = ctx.constrain(sc, Ax.BATCH, Ax.SEQ, None, None, None, None)
    dev = q.device
    i = torch.arange(w, device=dev)[:, None]           # q index within block
    jj = torch.arange(2 * w, device=dev)[None, :]      # k index in the window
    band = (jj <= i + w) & (jj > i)                    # causal + window
    n = torch.arange(nb, device=dev)[:, None, None] + n0
    valid = ((n - 1) * w + jj[None]) >= 0     # first block has no predecessor
    mask = band[None] & valid
    sc = torch.where(mask[None, :, None, None], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = _ein("bnkgqt,bntkd->bnqkgd", p.to(q.dtype), vcat)
    out = out.reshape(b, sq, h, hd).to(q.dtype)
    return ctx.constrain(out, Ax.BATCH, Ax.SEQ, None, None)


def attention_decode(q, cache_k, cache_v, t, *, window: int,
                     ctx: ShardingCtx):
    """Single-token attention over the KV cache.

    q: [b, 1, h, hd]; cache_k/v: [b, S, kvh, hd]; t: current position
    (an int or a 0-d tensor, the new token's index). Attends to positions
    <= t.
    """
    b, _, h, hd = q.shape
    S, kvh = cache_k.shape[1], cache_k.shape[2]
    g = h // kvh
    qg = q.reshape(b, 1, kvh, g, hd)
    scale = 1.0 / (hd ** 0.5)
    sc = _ein("bqkgd,btkd->bkgqt", qg, cache_k) * scale
    sc = ctx.constrain(sc, Ax.BATCH, None, None, None, Ax.KV_SEQ)
    kpos = torch.arange(S, device=q.device)
    mask = kpos[None, :] <= t
    if window:
        mask &= kpos[None, :] > (t - window)
    sc = torch.where(mask[None, None, None], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = _ein("bkgqt,btkd->bqkgd", p.to(q.dtype), cache_v)
    return out.reshape(b, 1, h, hd).to(q.dtype)


def attn_layer(x, p, arch: ArchConfig, layer_idx: int, ctx: ShardingCtx, *,
               positions, kv_block: int = 2048,
               cache: Optional[dict] = None, t=None, collect_kv: bool = False):
    """Full attention sublayer. Returns (out, new_cache_entry_or_None).

    In decode (``cache`` given) the new k/v are written into the cache
    tensors at position ``t`` in place, as the reference's donated decode
    updates its cache (a DTensor cache: into a new one), and the cache
    entry is returned.
    """
    window = 0
    if arch.swa_window and layer_idx not in arch.global_attn_layers:
        window = arch.swa_window
    s = x.shape[1]
    use_blocked = (window and s % window == 0
                   and (s // window) >= max(ctx.model_size, 2))
    if cache is None and ctx.seq_split(x.shape):
        return _attn_split(x, p, arch, ctx, window=window,
                           blocked=use_blocked, positions=positions,
                           kv_block=kv_block, collect_kv=collect_kv)
    q, k, v = _qkv(x, p, arch, ctx, positions=positions)
    new_cache = None
    if cache is not None:
        idx = positions.reshape(1)
        ck = _write_at(cache["k"], idx, k)
        cv = _write_at(cache["v"], idx, v)
        ck = ctx.constrain(ck, Ax.BATCH, Ax.KV_SEQ, None, None)
        cv = ctx.constrain(cv, Ax.BATCH, Ax.KV_SEQ, None, None)
        o = attention_decode(q, ck, cv, t, window=window, ctx=ctx)
        new_cache = dict(k=ck, v=cv)
    else:
        if use_blocked:
            o = attention_swa_blocked(q, k, v, window=window, ctx=ctx)
        else:
            o = attention_prefill(q, k, v, causal=arch.causal, window=window,
                                  ctx=ctx, kv_block=kv_block)
        if collect_kv:
            new_cache = dict(k=k, v=v)
    b, sq = o.shape[0], o.shape[1]
    o = o.reshape(b, sq, arch.n_heads * arch.head_dim)
    o = ctx.constrain(o, Ax.BATCH, Ax.SEQ, None)
    return o @ ctx.cast(p["wo"]), new_cache


def _qkv_block(x, positions, *w, arch: ArchConfig, ctx: ShardingCtx):
    """``_qkv`` on a rank's positions, the weights (and biases) whole."""
    names = ("wq", "wk", "wv", "bq", "bk", "bv")
    return _qkv(x, dict(zip(names, w)), arch, ctx, positions)


def _attn_block(q, k, v, wo, *, arch: ArchConfig, ctx: ShardingCtx,
                window: int, blocked: bool, q_offset: int, kv_block: int):
    """A rank's queries against every key, and the output projection."""
    if blocked:
        o = attention_swa_blocked(q, k, v, window=window, ctx=ctx,
                                  q_offset=q_offset)
    else:
        o = attention_prefill(q, k, v, causal=arch.causal, window=window,
                              ctx=ctx, kv_block=kv_block, q_offset=q_offset)
    b, sq = o.shape[0], o.shape[1]
    return (o.reshape(b, sq, arch.n_heads * arch.head_dim) @ wo,)


def _attn_split(x, p, arch: ArchConfig, ctx: ShardingCtx, *, window: int,
                blocked: bool, positions, kv_block: int, collect_kv: bool):
    """Context-parallel prefill of a sequence split over ``model``: q, k
    and v on each rank's positions (``positions`` cut like the
    sequence), k and v gathered at the second region's edge (their
    gradients reduced back onto the split), the output left split. A
    sliding window runs blocked where each rank holds whole w-blocks; the
    block before a rank's first comes from the gathered k/v."""
    b, s = x.shape[0], x.shape[1]
    s_loc = s // ctx.model_size
    ws = [ctx.cast(p[k]) for k in (("wq", "wk", "wv", "bq", "bk", "bv")
                                    if arch.qkv_bias else ("wq", "wk", "wv"))]
    q, k, v = ctx.split_region(
        functools.partial(_qkv_block, arch=arch, ctx=ctx), x.shape,
        ("seq", "pos") + ("whole",) * len(ws), ("seq",) * 3)(
        x, positions, *ws)
    (o,) = ctx.split_region(
        functools.partial(_attn_block, arch=arch, ctx=ctx, window=window,
                          blocked=bool(blocked) and s_loc % window == 0,
                          q_offset=ctx.model_rank * s_loc,
                          kv_block=kv_block), x.shape,
        ("seq", "batch", "batch", "whole"), ("seq",))(
        q, k, v, ctx.cast(p["wo"]))
    return o, (dict(k=k, v=v) if collect_kv else None)


def _write_at(cache, idx, new):
    """``new`` [b, 1, kvh, hd] written into ``cache`` at position ``idx``:
    in place, or, for a DTensor cache (a sharded dim takes no in-place
    write), as a new cache with the same values."""
    if isinstance(cache, DTensor):
        at = torch.arange(cache.shape[1], device=idx.device) == idx
        return torch.where(at[None, :, None, None], new.to(cache.dtype),
                           cache)
    return cache.index_copy_(1, idx, new.to(cache.dtype))


def cache_decls(arch: ArchConfig, batch: int, max_len: int, dtype) -> dict:
    """KV-cache declarations per layer (batch over data, seq over model)."""
    kvh, hd = arch.n_kv_heads, arch.head_dim
    return dict(
        k=ParamDecl((batch, max_len, kvh, hd),
                    (Ax.BATCH, Ax.KV_SEQ, None, None), init="zeros",
                    dtype=dtype),
        v=ParamDecl((batch, max_len, kvh, hd),
                    (Ax.BATCH, Ax.KV_SEQ, None, None), init="zeros",
                    dtype=dtype),
    )
