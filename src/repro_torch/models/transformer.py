"""Model assembly for all assigned architecture families
(``repro/models/transformer.py``).

``build_model(arch, ctx)`` returns a ``ModelBundle`` of pure functions on
dicts of tensors, over the reference's parameter tree (``emb``,
``layer_{i}``, ``ln_f``, ``head``, ...):

  * ``decls``            — ParamDecl tree (init, abstract shapes, specs)
  * ``features``         — backbone features (pre-unembed), MoE aux, the
                           audio label mask and optionally the cache
  * ``forward``          — logits for train/prefill
  * ``loss``             — scalar LM / masked-unit loss (+ MoE aux)
  * ``prefill``          — last-token logits + the populated decode cache
  * ``make_cache_decls`` — decode-state declarations
  * ``decode_step``      — one-token step against the cache

Families:
  dense / vlm / audio : pre-norm attention + SwiGLU
  moe                 : pre-norm attention + (shared + routed top-k) MoE
  ssm                 : mamba-2 SSD blocks (no attention, no MLP)
  hybrid (hymba)      : parallel attention ∥ SSD heads, fused by mean of
                        the two normed branch outputs, + SwiGLU MLP;
                        learnable meta tokens prepended; SWA except global
                        layers

The layers run as a Python loop. The reference scans homogeneous layer
segments (``_layer_segments``), which is the same math. ``loss`` runs
each layer under activation checkpointing as the arch says
(``ArchConfig.remat`` / ``remat_policy``, as the reference's
``jax.checkpoint``): ``"dots"`` saves the outputs of the weight
projections (``aten.mm`` / ``aten.addmm``, products without batch dims:
``dots_with_no_batch_dims_saveable``) and recomputes the rest in the
backward, ``"full"`` saves nothing. Remat changes memory and time, never
the numbers.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.config import ArchConfig, ShapeConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.parallel.sharding import Ax, ParamDecl, ShardingCtx

AUX_LOSS_W = 0.01


# ---------------------------------------------------------------------------
# Declarations
# ---------------------------------------------------------------------------

def _layer_decls(arch: ArchConfig, i: int) -> dict:
    d = arch.d_model
    decls: Dict[str, Any] = dict(ln1=L.rmsnorm_decl(d))
    if arch.n_heads:
        decls["attn"] = A.attn_decls(arch)
    if arch.family == "ssm":
        decls["ssm"] = S.ssm_decls(arch)
        return decls  # mamba block: single norm, no MLP
    if arch.family == "hybrid":
        decls["ssm"] = S.ssm_decls(arch)
        decls["attn_branch_norm"] = L.rmsnorm_decl(d)
        decls["ssm_branch_norm"] = L.rmsnorm_decl(d)
    decls["ln2"] = L.rmsnorm_decl(d)
    if arch.moe.n_experts and i >= arch.moe.first_k_dense:
        decls["moe"] = M.moe_decls(arch)
    elif arch.moe.n_experts:
        decls["mlp"] = L.mlp_decls(d, arch.moe.d_ff_dense_first)
    elif arch.d_ff:
        decls["mlp"] = L.mlp_decls(d, arch.d_ff)
    return decls


def model_decls(arch: ArchConfig) -> dict:
    d = arch.d_model
    decls: Dict[str, Any] = dict(
        emb=L.embed_decl(arch.vocab_padded, d),
        ln_f=L.rmsnorm_decl(d),
    )
    if not arch.tie_embeddings:
        decls["head"] = ParamDecl((d, arch.vocab_padded), (Ax.EMBED, Ax.VOCAB))
    if arch.n_meta_tokens:
        decls["meta"] = ParamDecl((arch.n_meta_tokens, d), (None, Ax.EMBED),
                                  init="embed")
    if arch.vit_dim:
        decls["vit_proj"] = dict(
            w1=ParamDecl((arch.vit_dim, d), (None, Ax.EMBED)),
            w2=ParamDecl((d, d), (Ax.EMBED, None)),
        )
    if arch.frame_dim:
        decls["frame_proj"] = ParamDecl((arch.frame_dim, d), (None, Ax.EMBED))
        decls["mask_emb"] = ParamDecl((d,), (None,), init="embed")
    for i in range(arch.n_layers):
        decls[f"layer_{i}"] = _layer_decls(arch, i)
    return decls


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _block(x, p, arch: ArchConfig, i: int, ctx: ShardingCtx, *, positions,
           cache=None, t=None, collect_cache=False):
    """One transformer/SSM/hybrid block. Returns (x, aux, new_cache)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache: Dict[str, Any] = {}
    h = L.rmsnorm(x, p["ln1"], arch.norm_eps)

    if arch.family == "ssm":
        if cache is not None:
            y, st = S.ssd_decode_step(h, cache["ssm"], p["ssm"], arch, ctx)
            new_cache["ssm"] = st
        else:
            y = S.ssd_prefill(h, p["ssm"], arch, ctx,
                              return_state=collect_cache)
            if collect_cache:
                y, new_cache["ssm"] = y
        return x + y, aux, new_cache

    ao, kv = A.attn_layer(h, p["attn"], arch, i, ctx, positions=positions,
                          cache=cache.get("kv") if cache else None, t=t,
                          collect_kv=collect_cache)
    if arch.family == "hybrid":
        if cache is not None:
            so, st = S.ssd_decode_step(h, cache["ssm"], p["ssm"], arch, ctx)
            new_cache = dict(kv=kv, ssm=st)
        else:
            so = S.ssd_prefill(h, p["ssm"], arch, ctx,
                               return_state=collect_cache)
            if collect_cache:
                so, st = so
                new_cache = dict(kv=kv, ssm=st)
        ao = L.rmsnorm(ao, p["attn_branch_norm"], arch.norm_eps)
        so = L.rmsnorm(so, p["ssm_branch_norm"], arch.norm_eps)
        x = x + 0.5 * (ao + so)
    else:
        if cache is not None or collect_cache:
            new_cache["kv"] = kv
        x = x + ao

    h2 = L.rmsnorm(x, p["ln2"], arch.norm_eps)
    if "moe" in p:
        # expert parallelism (``moe_ffn_ep``) is the default under a mesh;
        # ``moe_impl="gspmd"`` keeps the DP-grouped dispatch of ``moe_ffn``
        moe_fn = (M.moe_ffn
                  if ctx.overrides.get("moe_impl", "ep") == "gspmd"
                  else M.moe_ffn_ep)
        y, a = moe_fn(h2, p["moe"], arch, ctx)
        aux = aux + a
    else:
        y = L.mlp(h2, p["mlp"], ctx)
    x = ctx.constrain(x + y, Ax.BATCH, Ax.SEQ, None)
    return x, aux, new_cache


# ---------------------------------------------------------------------------
# Embedding frontends
# ---------------------------------------------------------------------------

def _frontend(params, batch, arch: ArchConfig, ctx: ShardingCtx):
    """Returns (x [b, s_total, d], label_mask or None)."""
    if arch.family == "audio":
        frames = batch["frames"].to(ctx.compute_dtype)
        dev = frames.device
        # deterministic ~8% span masking (multiplicative hash, uint32)
        s = frames.shape[1]
        pos = torch.arange(s, dtype=torch.int64, device=dev)
        masked = ((pos * 2654435761) % (1 << 32)) % 100 < 8
        x = frames @ ctx.cast(params["frame_proj"])
        x = torch.where(masked[None, :, None], ctx.cast(params["mask_emb"]),
                        x)
        # sinusoidal absolute positions (conv-pos stub)
        d = arch.d_model
        inv = 1.0 / (10000.0 ** (torch.arange(0, d, 2, dtype=torch.float32,
                                              device=dev) / d))
        ang = pos.float()[:, None] * inv[None, :]
        pe = torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(x.dtype)
        return ctx.constrain(x + pe[None], Ax.BATCH, Ax.SEQ, None), masked

    parts = []
    if arch.n_meta_tokens:
        b = batch["tokens"].shape[0]
        parts.append(ctx.cast(params["meta"])[None].expand(
            b, arch.n_meta_tokens, arch.d_model))
    if arch.vit_dim:
        pe = batch["patch_embeds"].to(ctx.compute_dtype)
        proj = F.gelu(pe @ ctx.cast(params["vit_proj"]["w1"]),
                      approximate="tanh")      # jax.nn.gelu's default
        parts.append(proj @ ctx.cast(params["vit_proj"]["w2"]))
    parts.append(L.embed_lookup(batch["tokens"], params["emb"], ctx))
    x = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    return ctx.constrain(x, Ax.BATCH, Ax.SEQ, None), None


def prefix_len(arch: ArchConfig) -> int:
    return arch.n_meta_tokens + (arch.n_patches if arch.vit_dim else 0)


# ---------------------------------------------------------------------------
# Bundle
# ---------------------------------------------------------------------------

@dataclass
class ModelBundle:
    arch: ArchConfig
    ctx: ShardingCtx
    decls: dict
    features: Callable
    forward: Callable
    prefill: Callable
    loss: Callable
    make_cache_decls: Callable
    decode_step: Callable


def _logits(x, params, arch: ArchConfig, ctx: ShardingCtx):
    if ctx.seq_split(x.shape):
        # the sequence gathered at the edge; the logits vocab-parallel
        x = ctx.constrain(x, Ax.BATCH, None, None)
    if arch.tie_embeddings:
        return L.unembed(x, params["emb"], ctx, real_vocab=arch.vocab)
    logits = ctx.constrain(x @ ctx.cast(params["head"]), Ax.BATCH, None,
                           Ax.VOCAB_ACT)
    return L.mask_vocab_pad(logits, arch.vocab)


def _last_block(x, *, last: bool):
    return (torch.where(torch.tensor(last, device=x.device), x[:, -1:], 0.0),)


def _last_position(x, ctx: ShardingCtx):
    """``x[:, -1:]``; of a sequence split over ``model``, the last rank's
    last position, summed over ``model`` (the other ranks give zeros)."""
    if not ctx.seq_split(x.shape):
        return x[:, -1:]
    (y,) = ctx.split_region(
        functools.partial(_last_block,
                          last=ctx.model_rank == ctx.model_size - 1),
        x.shape, ("seq",), ("seq_sum",))(x)
    return ctx.constrain(y, Ax.BATCH, None, None)


def _head_block(x, w):
    return (x @ w,)


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat_policy="dots"``: keep the
    products without batch dims (the projections' ``mm`` / ``addmm``),
    recompute everything else (norms, RoPE, the attention ``bmm``s)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_kwargs(arch: ArchConfig) -> dict:
    """``torch.utils.checkpoint.checkpoint``'s keywords for the arch's
    remat policy: ``"dots"`` selective, ``"full"`` saving nothing."""
    kw = dict(use_reentrant=False)
    if arch.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    elif arch.remat_policy != "full":
        raise ValueError(f"unknown remat_policy {arch.remat_policy!r}")
    return kw


def build_model(arch: ArchConfig, ctx: ShardingCtx) -> ModelBundle:
    decls = model_decls(arch)
    remat_kw = _remat_kwargs(arch) if arch.remat else None

    def features(params, batch, *, collect_cache=False, use_remat=True):
        """Backbone forward -> final-norm features (pre-unembed), the MoE
        aux total, the audio label mask and (``collect_cache``) the
        per-layer decode cache. With ``use_remat`` (and ``arch.remat``)
        each layer runs under activation checkpointing; the cache is
        collected without it."""
        x, label_mask = _frontend(params, batch, arch, ctx)
        positions = torch.arange(x.shape[1], device=x.device)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        cache = {}
        remat = remat_kw is not None and use_remat and not collect_cache
        for i in range(arch.n_layers):
            p_i = params[f"layer_{i}"]
            if remat:
                x, aux = checkpoint(_layer, x, p_i, i, positions,
                                    **remat_kw)
                nc = None
            else:
                x, aux, nc = _block(x, p_i, arch, i, ctx,
                                    positions=positions,
                                    collect_cache=collect_cache)
            if collect_cache:
                cache[f"layer_{i}"] = nc
            aux_total = aux_total + aux
        x = L.rmsnorm(x, params["ln_f"], arch.norm_eps)
        return x, aux_total, label_mask, cache

    def _layer(x, p_i, i, positions):
        x, aux, _ = _block(x, p_i, arch, i, ctx, positions=positions)
        return x, aux

    def forward(params, batch):
        x, aux_total, label_mask, _ = features(params, batch,
                                               use_remat=False)
        return _logits(x, params, arch, ctx), aux_total, label_mask

    def loss(params, batch):
        """Mean next-token (audio: masked-unit) cross entropy over the
        label positions, plus ``AUX_LOSS_W`` times the MoE aux loss."""
        x, aux, label_mask, _ = features(params, batch)
        labels = batch["labels"]
        mask = None
        if arch.family == "audio":
            mask = label_mask[None].float().expand(labels.shape)
        emb_or_head = params["emb"] if arch.tie_embeddings else params["head"]
        l = L.lm_loss_chunked(x, emb_or_head, labels, ctx,
                              tied=arch.tie_embeddings, mask=mask,
                              real_vocab=arch.vocab, prefix=prefix_len(arch))
        return l + AUX_LOSS_W * aux

    def prefill(params, batch):
        """Serving prefill: last-token logits + populated decode cache
        (an encoder's: the full frame logits and no cache)."""
        x, _, _, cache = features(params, batch, collect_cache=True,
                                  use_remat=False)
        if arch.is_encoder_only:
            w = ctx.cast(params["head"])
            if ctx.seq_split(x.shape):
                (logits,) = ctx.split_region(
                    _head_block, x.shape, ("seq", "whole"), ("seq",))(x, w)
            else:
                logits = x @ w
            logits = ctx.constrain(logits, Ax.BATCH, Ax.SEQ, None)
            return L.mask_vocab_pad(logits, arch.vocab), {}
        return _logits(_last_position(x, ctx), params, arch, ctx), cache

    def make_cache_decls(batch_size: int, max_len: int):
        assert not arch.is_encoder_only, "encoder-only arch has no decode"
        cache = {}
        for i in range(arch.n_layers):
            entry = {}
            if arch.n_heads:
                entry["kv"] = A.cache_decls(arch, batch_size, max_len,
                                            ctx.compute_dtype)
            if arch.family in ("ssm", "hybrid"):
                entry["ssm"] = S.ssm_state_decls(arch, batch_size)
            cache[f"layer_{i}"] = entry
        return cache

    def decode_step(params, cache, token, t):
        """token: [b, 1] int; t: the position (an int or a 0-d tensor).
        -> (logits, new_cache); the KV entries are written in place."""
        x = ctx.constrain(L.embed_lookup(token, params["emb"], ctx),
                          Ax.BATCH, None, None)
        if isinstance(t, torch.Tensor):
            positions = t.reshape(1).to(device=x.device, dtype=torch.int64)
        else:
            positions = torch.full((1,), int(t), dtype=torch.int64,
                                   device=x.device)
        new_cache = {}
        for i in range(arch.n_layers):
            x, _, nc = _block(x, params[f"layer_{i}"], arch, i, ctx,
                              positions=positions,
                              cache=cache[f"layer_{i}"], t=t)
            new_cache[f"layer_{i}"] = nc
        x = L.rmsnorm(x, params["ln_f"], arch.norm_eps)
        return _logits(x, params, arch, ctx), new_cache

    def scoped(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with ctx.scope():
                return fn(*args, **kwargs)
        return run

    return ModelBundle(arch=arch, ctx=ctx, decls=decls,
                       features=scoped(features), forward=scoped(forward),
                       prefill=scoped(prefill), loss=scoped(loss),
                       make_cache_decls=make_cache_decls,
                       decode_step=scoped(decode_step))


# ---------------------------------------------------------------------------
# Input specs (meta-device stand-ins; no allocation)
# ---------------------------------------------------------------------------

def _spec(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(arch: ArchConfig, shape: ShapeConfig,
                ctx: ShardingCtx) -> dict:
    """Abstract inputs (``meta`` tensors) for every model input of the
    given shape cell."""
    B, Sq = shape.global_batch, shape.seq_len
    pl = prefix_len(arch)
    if shape.kind in ("train", "prefill"):
        if arch.family == "audio":
            specs = dict(frames=_spec((B, Sq, arch.frame_dim), torch.float32),
                         labels=_spec((B, Sq), torch.int32))
        elif arch.vit_dim:
            specs = dict(
                tokens=_spec((B, Sq - pl), torch.int32),
                patch_embeds=_spec((B, arch.n_patches, arch.vit_dim),
                                   torch.float32),
                labels=_spec((B, Sq - pl), torch.int32))
        else:
            specs = dict(tokens=_spec((B, Sq - pl), torch.int32),
                         labels=_spec((B, Sq - pl), torch.int32))
        if shape.kind == "prefill":
            specs.pop("labels")
        return specs
    # decode
    return dict(token=_spec((B, 1), torch.int32))


def input_shardings(arch: ArchConfig, shape: ShapeConfig,
                    ctx: ShardingCtx) -> dict:
    """The placements of every model input of the shape cell: batch over
    the data axes (``None`` leaves without a mesh)."""
    out = {}
    for k, v in input_specs(arch, shape, ctx).items():
        axes = (Ax.BATCH,) + (None,) * (v.ndim - 1)
        out[k] = ctx.act_sharding(axes, tuple(v.shape))
    return out
