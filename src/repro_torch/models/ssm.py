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


def _causal_conv(x, w, b):
    """Depthwise causal conv via k shifted adds. x: [b, s, c]; w: [k, c]."""
    k = w.shape[0]
    y = x * w[k - 1]
    for i in range(1, k):
        shifted = pad_dim1(x, i, 0)[:, :-i]
        y = y + shifted * w[k - 1 - i]
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


def ssd_prefill(x, p, arch: ArchConfig, ctx: ShardingCtx, *,
                return_state=False):
    """Full-sequence SSD. x: [b, s, d] -> [b, s, d] (+ final ssm state)."""
    b, s_in, d = x.shape
    cfg = arch.ssm
    di, nh, conv_dim = ssm_dims(arch)
    hd, ns, ng = cfg.head_dim, cfg.d_state, cfg.n_groups
    Q = min(cfg.chunk, s_in)
    pad = (-s_in) % Q
    if pad:
        # zero-pad the tail to a chunk multiple (outputs are sliced back;
        # only valid with return_state=False, since the tail would pollute
        # the final state)
        assert not return_state, "padded prefill cannot return a state"
        x = pad_dim1(x, 0, pad)
    s_len = s_in + pad
    nc = s_len // Q
    dev = x.device

    zxbcdt = x @ ctx.cast(p["w_in"])
    z, xconv_raw, dt = _split_proj(zxbcdt, arch)
    xconv = F.silu(_causal_conv(xconv_raw, ctx.cast(p["conv_w"]),
                                ctx.cast(p["conv_b"])))
    xs = xconv[..., :di].reshape(b, s_len, nh, hd)
    Bm = xconv[..., di:di + ng * ns].reshape(b, s_len, ng, ns)
    Cm = xconv[..., di + ng * ns:].reshape(b, s_len, ng, ns)
    # broadcast groups over heads
    rep = nh // ng
    Bh = torch.repeat_interleave(Bm, rep, dim=2)      # [b, s, nh, ns]
    Ch = torch.repeat_interleave(Cm, rep, dim=2)

    dt = _softplus(dt.float() + p["dt_bias"].float())
    dt = torch.clamp(dt, cfg.dt_min, cfg.dt_max * 100)
    a = -torch.exp(p["a_log"].float())                # [nh], a < 0
    dA = dt * a                                       # [b, s, nh] (log decay)

    def chunk(t):
        return t.reshape(b, nc, Q, *t.shape[2:])
    xs_c, Bh_c, Ch_c, dt_c, dA_c = map(chunk, (xs, Bh, Ch, dt, dA))
    xs_c = ctx.constrain(xs_c, Ax.BATCH, Ax.SEQ, None, None, None)
    Bh_c = ctx.constrain(Bh_c, Ax.BATCH, Ax.SEQ, None, None, None)
    Ch_c = ctx.constrain(Ch_c, Ax.BATCH, Ax.SEQ, None, None, None)
    dt_c = ctx.constrain(dt_c, Ax.BATCH, Ax.SEQ, None, None)
    dA_c = ctx.constrain(dA_c, Ax.BATCH, Ax.SEQ, None, None)

    cum = torch.cumsum(dA_c, dim=2)                   # [b, nc, Q, nh]
    total = cum[:, :, -1]                             # [b, nc, nh]

    # ---- intra-chunk (masked kernel matmul) -------------------------------
    # L[i,j] = exp(cum_i - cum_j) for i >= j. The mask goes inside the exp:
    # above the diagonal cum_i - cum_j > 0 can overflow to inf, and a
    # where() after the exp would send 0 * inf = NaN into the gradient
    # (the reference's order, repro/models/ssm.py:126); the values are
    # the same
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [b,nc,Qi,Qj,nh]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=dev))
    L = torch.exp(torch.where(tri[None, None, :, :, None], diff,
                              float("-inf")))
    scores = _ein("bcihn,bcjhn->bcijh", Ch_c, Bh_c)
    scores = ctx.constrain(scores, Ax.BATCH, Ax.SEQ, None, None, None)
    M = scores * L * dt_c[:, :, None, :, :]           # [b,nc,Q,Q,nh]
    y_diag = _ein("bcijh,bcjhp->bcihp", M.to(x.dtype), xs_c)
    y_diag = ctx.constrain(y_diag, Ax.BATCH, Ax.SEQ, None, None, None)

    # ---- chunk states ------------------------------------------------------
    # S_c = Σ_j exp(total_c - cum_j) dt_j B_j ⊗ x_j    [b, nc, nh, ns, hd]
    decay_to_end = torch.exp(total[:, :, None] - cum) * dt_c   # [b,nc,Q,nh]
    Sc = _ein("bcjhn,bcjhp->bchnp",
              (Bh_c * decay_to_end[..., None]).to(x.dtype), xs_c)

    # ---- inter-chunk state passing as a decay-matrix matmul ---------------
    # H_c (state entering chunk c) = Σ_{j<c} exp(Σ_{m=j+1..c-1} total_m) S_j
    tot_cum = torch.cumsum(total, dim=1)              # [b, nc, nh]
    dd = tot_cum[:, :, None, :] - tot_cum[:, None, :, :]   # [b, c, j, nh]
    strict = torch.tril(torch.ones((nc, nc), dtype=torch.bool, device=dev),
                        diagonal=-1)
    dmat = torch.exp(torch.where(strict[None, :, :, None],
                                 dd - total[:, :, None, :], float("-inf")))
    H = _ein("bcjh,bjhnp->bchnp", dmat, Sc)           # [b,nc,nh,ns,hd]

    # ---- inter-chunk output contribution -----------------------------------
    in_decay = torch.exp(cum)                         # decay from chunk start
    y_off = _ein("bcihn,bchnp->bcihp",
                 (Ch_c * in_decay[..., None]).to(x.dtype), H.to(x.dtype))

    y = (y_diag + y_off).reshape(b, s_len, nh, hd)
    y = y + xs * p["d_skip"].float()[None, None, :, None]
    y = y.reshape(b, s_len, di).to(x.dtype)
    y = ctx.constrain(y, Ax.BATCH, Ax.SEQ, None)
    y = rmsnorm_gated(y, z, p["norm_w"], arch.norm_eps)
    out = y @ ctx.cast(p["w_out"])
    if pad:
        out = out[:, :s_in]
    if return_state:
        final = H[:, -1] * torch.exp(total[:, -1])[..., None, None] + Sc[:, -1]
        state = dict(conv=xconv_raw[:, -(cfg.d_conv - 1):].float(),
                     ssm=final)                       # [b, nh, ns, hd]
        return out, state
    return out


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
