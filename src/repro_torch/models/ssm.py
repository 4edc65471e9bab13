"""Mamba-2 SSD (state-space duality) block (``repro/models/ssm.py``).

The chunked SSD algorithm as the reference writes it, in einsums:

  * intra-chunk: (C_i·B_j) ⊙ decay-kernel, a [Q,Q] product per chunk;
  * inter-chunk state passing: the cumulative states as an O(nc²)
    decay-matrix product h_c = Σ_{j<c} (Π decay) S_j, not a sequential
    scan over chunks.

Contractions run on fp32 operands and return fp32 (the reference's
``preferred_element_type=jnp.float32``).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.config import ArchConfig
from repro_torch.models.layers import pad_dim1, rmsnorm_gated
from repro_torch.parallel.sharding import Ax, ParamDecl, ShardingCtx


def _ein(eq, a, b):
    return torch.einsum(eq, a.float(), b.float())


def ssm_dims(arch: ArchConfig):
    s = arch.ssm
    di = arch.d_model * s.expand
    nh = di // s.head_dim
    conv_dim = di + 2 * s.n_groups * s.d_state
    return di, nh, conv_dim


def ssm_decls(arch: ArchConfig) -> dict:
    d = arch.d_model
    s = arch.ssm
    di, nh, conv_dim = ssm_dims(arch)
    d_in_proj = 2 * di + 2 * s.n_groups * s.d_state + nh
    return dict(
        # w_in's packed output (z ++ xBC ++ dt) is FSDP-sharded on the
        # embed dim only: it must not be split mid-field
        w_in=ParamDecl((d, d_in_proj), (Ax.EMBED, None)),
        conv_w=ParamDecl((s.d_conv, conv_dim), (None, None), scale=0.5),
        conv_b=ParamDecl((conv_dim,), (None,), init="zeros"),
        a_log=ParamDecl((nh,), (None,), init="zeros"),
        dt_bias=ParamDecl((nh,), (None,), init="zeros"),
        d_skip=ParamDecl((nh,), (None,), init="ones"),
        norm_w=ParamDecl((di,), (None,), init="ones"),
        w_out=ParamDecl((di, d), (Ax.FF, Ax.EMBED)),
    )


def _causal_conv(x, w, b, prev=None):
    """Depthwise causal conv via k shifted adds. x: [b, s, c]; w: [k, c];
    ``prev``: the k - 1 positions before ``x`` ([b, k - 1, c]; zeros
    where ``None``)."""
    k, s = w.shape[0], x.shape[1]
    xp = pad_dim1(x, k - 1, 0) if prev is None else torch.cat([prev, x], 1)
    y = x * w[k - 1]
    for i in range(1, k):
        y = y + xp[:, k - 1 - i:k - 1 - i + s] * w[k - 1 - i]
    return y + b


def _split_proj(zxbcdt, arch: ArchConfig):
    s = arch.ssm
    di, nh, _ = ssm_dims(arch)
    gs = s.n_groups * s.d_state
    z = zxbcdt[..., :di]
    xc = zxbcdt[..., di:2 * di + 2 * gs]       # x ++ B ++ C (conv input)
    dt = zxbcdt[..., 2 * di + 2 * gs:]
    return z, xc, dt


def _softplus(x):
    """``jax.nn.softplus`` (log(1 + e^x)), with no threshold cut."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _conv_terms(xconv_raw, dt, conv_w, conv_b, dt_bias, a_log,
                arch: ArchConfig, Q: int, prev=None):
    """The causal conv and SiLU, the heads' x, B and C and the step sizes:
    ``xs`` [b, s, nh, hd] and, in the chunk layout [b, nc, Q, ...], x, B,
    C, dt and the log decay dA."""
    b, s_len, _ = xconv_raw.shape
    cfg = arch.ssm
    di, nh, _ = ssm_dims(arch)
    hd, ns, ng = cfg.head_dim, cfg.d_state, cfg.n_groups
    xconv = F.silu(_causal_conv(xconv_raw, conv_w, conv_b, prev))
    xs = xconv[..., :di].reshape(b, s_len, nh, hd)
    Bm = xconv[..., di:di + ng * ns].reshape(b, s_len, ng, ns)
    Cm = xconv[..., di + ng * ns:].reshape(b, s_len, ng, ns)
    # broadcast groups over heads
    rep = nh // ng
    Bh = torch.repeat_interleave(Bm, rep, dim=2)      # [b, s, nh, ns]
    Ch = torch.repeat_interleave(Cm, rep, dim=2)

    dt = _softplus(dt.float() + dt_bias.float())
    dt = torch.clamp(dt, cfg.dt_min, cfg.dt_max * 100)
    a = -torch.exp(a_log.float())                     # [nh], a < 0
    dA = dt * a                                       # [b, s, nh] (log decay)

    def chunk(t):
        return t.reshape(b, s_len // Q, Q, *t.shape[2:])
    return xs, tuple(map(chunk, (xs, Bh, Ch, dt, dA)))


def _intra_chunk(xs_c, Bh_c, Ch_c, dt_c, dA_c, dtype, ctx: ShardingCtx):
    """Each chunk's own output and state: ``(y_diag, Sc, cum, total)``."""
    Q = xs_c.shape[2]
    cum = torch.cumsum(dA_c, dim=2)                   # [b, nc, Q, nh]
    total = cum[:, :, -1]                             # [b, nc, nh]

    # ---- intra-chunk (masked kernel matmul) -------------------------------
    # L[i,j] = exp(cum_i - cum_j) for i >= j. The mask goes inside the exp:
    # above the diagonal cum_i - cum_j > 0 can overflow to inf, and a
    # where() after the exp would send 0 * inf = NaN into the gradient
    # (the reference's order, repro/models/ssm.py:126); the values are
    # the same
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [b,nc,Qi,Qj,nh]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                device=xs_c.device))
    L = torch.exp(torch.where(tri[None, None, :, :, None], diff,
                              float("-inf")))
    scores = _ein("bcihn,bcjhn->bcijh", Ch_c, Bh_c)
    scores = ctx.constrain(scores, Ax.BATCH, None, None, None, None)
    M = scores * L * dt_c[:, :, None, :, :]           # [b,nc,Q,Q,nh]
    y_diag = _ein("bcijh,bcjhp->bcihp", M.to(dtype), xs_c)
    y_diag = ctx.constrain(y_diag, Ax.BATCH, None, None, None, None)

    # ---- chunk states ------------------------------------------------------
    # S_c = Σ_j exp(total_c - cum_j) dt_j B_j ⊗ x_j    [b, nc, nh, ns, hd]
    decay_to_end = torch.exp(total[:, :, None] - cum) * dt_c   # [b,nc,Q,nh]
    Sc = _ein("bcjhn,bcjhp->bchnp",
              (Bh_c * decay_to_end[..., None]).to(dtype), xs_c)
    return y_diag, Sc, cum, total


def _states_in(Sc, total, c0: int = 0, n: int = 0):
    """The state entering chunks ``c0 .. c0 + n - 1`` (all where ``n`` is
    0) from every chunk's ``Sc`` [b, nc, nh, ns, hd] and ``total``
    [b, nc, nh], as a decay-matrix product:
    H_c = Σ_{j<c} exp(Σ_{m=j+1..c-1} total_m) S_j."""
    nc = Sc.shape[1]
    n = n or nc
    tot_cum = torch.cumsum(total, dim=1)              # [b, nc, nh]
    own = slice(c0, c0 + n)
    dd = tot_cum[:, own, None, :] - tot_cum[:, None, :, :]   # [b, c, j, nh]
    strict = torch.tril(torch.ones((nc, nc), dtype=torch.bool,
                                   device=Sc.device), diagonal=-1)[own]
    dmat = torch.exp(torch.where(strict[None, :, :, None],
                                 dd - total[:, own, None, :], float("-inf")))
    return _ein("bcjh,bjhnp->bchnp", dmat, Sc)       # [b, n, nh, ns, hd]


def _ssd_out(y_diag, Ch_c, cum, H, xs, z, d_skip, norm_w, w_out,
             arch: ArchConfig, ctx: ShardingCtx):
    """The inter-chunk contribution, the skip, the gated norm and the out
    projection: [b, s, d]."""
    b, s_len, nh, hd = xs.shape
    in_decay = torch.exp(cum)                         # decay from chunk start
    y_off = _ein("bcihn,bchnp->bcihp",
                 (Ch_c * in_decay[..., None]).to(xs.dtype), H.to(xs.dtype))
    y = (y_diag + y_off).reshape(b, s_len, nh, hd)
    y = y + xs * d_skip.float()[None, None, :, None]
    y = y.reshape(b, s_len, nh * hd).to(xs.dtype)
    y = ctx.constrain(y, Ax.BATCH, None, None)
    y = rmsnorm_gated(y, z, norm_w, arch.norm_eps)
    return y @ w_out


def ssd_prefill(x, p, arch: ArchConfig, ctx: ShardingCtx, *,
                return_state=False):
    """Full-sequence SSD. x: [b, s, d] -> [b, s, d] (+ final ssm state).

    The chunk dim [b, nc, ...] lies over ``model`` as the reference
    shards it (``nc`` divided by ``model`` on a device mesh): then the
    chunks run split (``_ssd_split``). Else they run whole on every rank,
    the sequence gathered at entry and cut again at exit."""
    b, s_in, d = x.shape
    Q = min(arch.ssm.chunk, s_in)
    pad = (-s_in) % Q
    if pad:
        # the tail zero-padded to a chunk multiple (outputs sliced back;
        # only valid with return_state=False, since the tail would pollute
        # the final state)
        assert not return_state, "padded prefill cannot return a state"
    nc = (s_in + pad) // Q
    if ctx.seq_split((b, nc)):
        return _ssd_split(x, p, arch, ctx, Q, pad, return_state)
    split = ctx.seq_split(x.shape)
    if split:
        x = ctx.constrain(x, Ax.BATCH, None, None)
    out = _ssd_whole(x, p, arch, ctx, Q, pad, return_state)
    if split:
        y = ctx.constrain(out[0] if return_state else out,
                          Ax.BATCH, Ax.SEQ, None)
        out = (y, out[1]) if return_state else y
    return out


def _ssd_whole(x, p, arch: ArchConfig, ctx: ShardingCtx, Q: int, pad: int,
               return_state: bool):
    """The SSD with every chunk on every rank of ``model`` (the
    reference's chunk-dim sites constrain to the batch split only; a
    split chunk dim runs in ``_ssd_split``)."""
    cfg = arch.ssm
    s_in = x.shape[1]
    if pad:
        x = pad_dim1(x, 0, pad)
    zxbcdt = x @ ctx.cast(p["w_in"])
    z, xconv_raw, dt = _split_proj(zxbcdt, arch)
    xs, chunks = _conv_terms(xconv_raw, dt, ctx.cast(p["conv_w"]),
                             ctx.cast(p["conv_b"]), p["dt_bias"],
                             p["a_log"], arch, Q)
    chunks = [ctx.constrain(t, Ax.BATCH, *(None,) * (t.ndim - 1))
              for t in chunks]
    xs_c, Bh_c, Ch_c, dt_c, dA_c = chunks
    y_diag, Sc, cum, total = _intra_chunk(xs_c, Bh_c, Ch_c, dt_c, dA_c,
                                          x.dtype, ctx)
    H = _states_in(Sc, total)                         # [b,nc,nh,ns,hd]
    out = _ssd_out(y_diag, Ch_c, cum, H, xs, z, p["d_skip"], p["norm_w"],
                   ctx.cast(p["w_out"]), arch, ctx)
    if pad:
        out = out[:, :s_in]
    if return_state:
        final = H[:, -1] * torch.exp(total[:, -1])[..., None, None] + Sc[:, -1]
        state = dict(conv=xconv_raw[:, -(cfg.d_conv - 1):].float(),
                     ssm=final)                       # [b, nh, ns, hd]
        return out, state
    return out


# ---------------------------------------------------------------------------
# The chunks split over ``model`` (regions of ``ShardingCtx.split_region``)
# ---------------------------------------------------------------------------

def _ssd_in_block(x, w_in, *, arch: ArchConfig):
    """The in projection of a rank's positions, and their last d_conv - 1
    conv inputs (the next rank's conv needs them)."""
    z, xconv_raw, dt = _split_proj(x @ w_in, arch)
    k = arch.ssm.d_conv
    return z, xconv_raw, dt, xconv_raw[:, xconv_raw.shape[1] - (k - 1):]


def _ssd_chunk_block(xconv_raw, dt, tails, conv_w, conv_b, dt_bias, a_log,
                     *, arch: ArchConfig, Q: int, rank: int,
                     ctx: ShardingCtx):
    """A rank's chunks: the conv behind the previous rank's tail (zeros on
    rank 0), the intra-chunk outputs and the chunk states ``Sc`` and log
    decays ``total`` (gathered at the edge for the inter-chunk pass)."""
    k = conv_w.shape[0]
    # rank 0's previous tail is the zero block before every rank's (a
    # slice of the tails all the same, so the tails' gradient, and the
    # collective that reduces it, exist on every rank)
    tails = torch.cat([torch.zeros_like(tails[:, :k - 1]), tails], 1)
    prev = tails[:, rank * (k - 1):(rank + 1) * (k - 1)]
    xs, (xs_c, Bh_c, Ch_c, dt_c, dA_c) = _conv_terms(
        xconv_raw, dt, conv_w, conv_b, dt_bias, a_log, arch, Q, prev)
    y_diag, Sc, cum, total = _intra_chunk(xs_c, Bh_c, Ch_c, dt_c, dA_c,
                                          xconv_raw.dtype, ctx)
    return Sc, total, y_diag, Ch_c, cum, xs


def _ssd_out_block(Sc_all, total_all, y_diag, Ch_c, cum, xs, z, d_skip,
                   norm_w, w_out, *, arch: ArchConfig, rank: int,
                   ctx: ShardingCtx):
    """A rank's chunks' entering states (the rows of its own chunks in
    the decay matrix over every chunk) and its output."""
    n = y_diag.shape[1]
    H = _states_in(Sc_all, total_all, rank * n, n)
    return (_ssd_out(y_diag, Ch_c, cum, H, xs, z, d_skip, norm_w, w_out,
                     arch, ctx),)


def _ssd_split(x, p, arch: ArchConfig, ctx: ShardingCtx, Q: int, pad: int,
               return_state: bool):
    """The SSD with each rank's chunks local, in three regions:

      1. the in projection on the rank's positions (``w_in`` gathered);
         each rank's last ``d_conv - 1`` conv inputs are gathered at the
         edge (not the whole conv input);
      2. the conv behind the previous rank's tail, the intra-chunk work
         and the chunk states ``Sc``, all local; ``Sc`` [b, nc, nh, ns,
         hd] and ``total`` [b, nc, nh] are gathered at the edge;
      3. each rank forms the decay-matrix rows of its own chunks only, the
         inter-chunk output, the gated norm and ``w_out`` (gathered).

    The final state (``return_state``) is formed from the gathered terms
    on every rank, outside the regions: the last rank's conv tail and
    Σ_j exp(Σ_{m>j} total_m) S_j."""
    cfg = arch.ssm
    s_in = x.shape[1]
    if pad:
        x = pad_dim1(ctx.constrain(x, Ax.BATCH, None, None), 0, pad)
    x = ctx.constrain(x, Ax.BATCH, Ax.SEQ, None)
    assert x.shape[1] // ctx.model_size >= cfg.d_conv - 1, x.shape
    rank = ctx.model_rank
    z, xconv_raw, dt, tails = ctx.split_region(
        functools.partial(_ssd_in_block, arch=arch), x.shape,
        ("seq", "whole"), ("seq",) * 4)(x, ctx.cast(p["w_in"]))
    gathered = ctx.act_sharding((Ax.BATCH, None, None), tuple(x.shape))
    tails = tails.redistribute(ctx.mesh, gathered)
    Sc, total, y_diag, Ch_c, cum, xs = ctx.split_region(
        functools.partial(_ssd_chunk_block, arch=arch, Q=Q, rank=rank,
                          ctx=ctx), x.shape,
        ("seq", "seq", "batch") + ("whole",) * 4, ("seq",) * 6)(
        xconv_raw, dt, tails, ctx.cast(p["conv_w"]), ctx.cast(p["conv_b"]),
        p["dt_bias"], p["a_log"])
    Sc_all, total_all = (t.redistribute(ctx.mesh, gathered)
                         for t in (Sc, total))
    (out,) = ctx.split_region(
        functools.partial(_ssd_out_block, arch=arch, rank=rank, ctx=ctx),
        x.shape, ("batch", "batch") + ("seq",) * 5 + ("whole",) * 3,
        ("seq",))(Sc_all, total_all, y_diag, Ch_c, cum, xs, z, p["d_skip"],
                  p["norm_w"], ctx.cast(p["w_out"]))
    if pad:
        out = ctx.constrain(out, Ax.BATCH, None, None)[:, :s_in]
        out = ctx.constrain(out, Ax.BATCH, Ax.SEQ, None)
    if not return_state:
        return out
    tot_cum = torch.cumsum(total_all, dim=1)
    final = _ein("bjh,bjhnp->bhnp", torch.exp(tot_cum[:, -1:] - tot_cum),
                 Sc_all)
    state = dict(conv=tails[:, -(cfg.d_conv - 1):].float(),
                 ssm=final)                           # [b, nh, ns, hd]
    return out, state


def ssd_decode_step(x_t, state, p, arch: ArchConfig, ctx: ShardingCtx):
    """One-token SSD update.

    x_t: [b, 1, d]; state: dict(conv=[b, k-1, conv_dim], ssm=[b, nh, ns,
    hd]). Returns (y_t [b, 1, d], new_state).
    """
    b = x_t.shape[0]
    cfg = arch.ssm
    di, nh, conv_dim = ssm_dims(arch)
    hd, ns, ng = cfg.head_dim, cfg.d_state, cfg.n_groups

    zxbcdt = x_t @ ctx.cast(p["w_in"])
    z, xc_new, dt = _split_proj(zxbcdt, arch)
    # rolling conv state
    conv_in = torch.cat([state["conv"], xc_new.to(state["conv"].dtype)],
                        dim=1)                        # [b, k, c]
    w = ctx.cast(p["conv_w"])
    xc = torch.sum(conv_in * w[None], dim=1, keepdim=True) + ctx.cast(
        p["conv_b"])
    xc = F.silu(xc)
    new_conv = conv_in[:, 1:]

    xs = xc[..., :di].reshape(b, nh, hd)
    Bm = xc[..., di:di + ng * ns].reshape(b, ng, ns)
    Cm = xc[..., di + ng * ns:].reshape(b, ng, ns)
    rep = nh // ng
    Bh = torch.repeat_interleave(Bm, rep, dim=1)
    Ch = torch.repeat_interleave(Cm, rep, dim=1)

    dt = _softplus(dt[:, 0].float() + p["dt_bias"].float())   # [b, nh]
    a = -torch.exp(p["a_log"].float())
    decay = torch.exp(dt * a)                                  # [b, nh]

    upd = _ein("bhn,bhp->bhnp", Bh * dt[..., None], xs)
    new_ssm = state["ssm"] * decay[..., None, None] + upd
    y = _ein("bhn,bhnp->bhp", Ch, new_ssm.to(x_t.dtype))
    y = y + xs * p["d_skip"].float()[None, :, None]
    y = y.reshape(b, 1, di).to(x_t.dtype)
    y = rmsnorm_gated(y, z, p["norm_w"], arch.norm_eps)
    return y @ ctx.cast(p["w_out"]), dict(conv=new_conv, ssm=new_ssm)


def ssm_state_decls(arch: ArchConfig, batch: int) -> dict:
    cfg = arch.ssm
    di, nh, conv_dim = ssm_dims(arch)
    return dict(
        conv=ParamDecl((batch, cfg.d_conv - 1, conv_dim),
                       (Ax.BATCH, None, None), init="zeros",
                       dtype=torch.float32),
        ssm=ParamDecl((batch, nh, cfg.d_state, cfg.head_dim),
                      (Ax.BATCH, None, None, None), init="zeros",
                      dtype=torch.float32),
    )
