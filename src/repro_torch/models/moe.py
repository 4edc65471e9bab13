"""Mixture-of-Experts layer: top-k routing, DP-grouped capacity dispatch
(``repro/models/moe.py``).

  * tokens are reshaped to [dp_groups, T, d] so that each data-parallel
    group dispatches its own tokens;
  * slot assignment is a cumsum over a [g, T*k, E] one-hot; tokens beyond
    expert capacity are dropped (GShard semantics);
  * the expert FFN is one grouped einsum over the expert weight stack.

The reference's expert-parallel ``moe_ffn_ep`` (``shard_map`` over the
``model`` axis) needs a device mesh and comes with it (``ROADMAP.md``);
without a mesh the reference runs this function.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ArchConfig
from repro_torch.models.layers import mlp, mlp_decls
from repro_torch.parallel.sharding import Ax, ParamDecl, ShardingCtx


def moe_decls(arch: ArchConfig) -> dict:
    d = arch.d_model
    m = arch.moe
    fe = m.d_ff_expert
    decls = dict(
        router=ParamDecl((d, m.n_experts), (Ax.EMBED, None), scale=0.02),
        we_gate=ParamDecl((m.n_experts, d, fe), (Ax.EXPERT, Ax.EMBED, None)),
        we_up=ParamDecl((m.n_experts, d, fe), (Ax.EXPERT, Ax.EMBED, None)),
        we_down=ParamDecl((m.n_experts, fe, d), (Ax.EXPERT, None, Ax.EMBED)),
    )
    if m.n_shared_experts:
        decls["shared"] = mlp_decls(d, fe * m.n_shared_experts)
    return decls


def _capacity(tokens_per_group: int, top_k: int, n_experts: int,
              cf: float) -> int:
    c = int(tokens_per_group * top_k / n_experts * cf)
    return max(4, c)


def moe_ffn(x, p, arch: ArchConfig, ctx: ShardingCtx, *, positions=None):
    """x: [b, s, d] (batch over data axes). Returns [b, s, d] + aux loss."""
    b, s, d = x.shape
    m = arch.moe
    E, K = m.n_experts, m.top_k
    dp = ctx.dp_size
    assert b % dp == 0, (b, dp)
    T = (b // dp) * s
    C = _capacity(T, K, E, m.capacity_factor)
    dev = x.device

    xg = x.reshape(dp, T, d)

    # --- routing (fp32) ----------------------------------------------------
    logits = xg.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)                    # [g, T, E]
    gates, eidx = torch.topk(probs, K, dim=-1)               # [g, T, K]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    # load-balancing auxiliary loss (Switch-style)
    me = torch.mean(probs, dim=(0, 1))                       # [E]
    ce = torch.mean(F.one_hot(eidx, E).float().sum(dim=2),
                    dim=(0, 1)) / K                          # assignments/tok
    aux = E * torch.sum(me * ce)                             # ==1 if balanced

    # --- slot assignment ----------------------------------------------------
    eflat = eidx.reshape(dp, T * K)                          # [g, TK]
    oh = F.one_hot(eflat, E)                                 # [g, TK, E]
    pos_all = torch.cumsum(oh, dim=1) - 1                    # position per expert
    pos = torch.gather(pos_all, 2, eflat[..., None])[..., 0]
    keep = pos < C                                           # dropped beyond capacity

    # slot -> token map: slot_tok[g, e, c] = token index (or T: dummy)
    tok_of_entry = torch.arange(T * K, device=dev) // K      # [TK]
    gi = torch.arange(dp, device=dev)[:, None].expand(dp, T * K)
    e_safe = torch.where(keep, eflat, 0)
    pos_safe = torch.where(keep, pos, C)                     # C -> dropped row
    slot_tok = torch.full((dp, E, C + 1), T, dtype=torch.int64, device=dev)
    slot_tok[gi, e_safe, pos_safe] = torch.where(
        keep, tok_of_entry[None], T)
    slot_tok = slot_tok[:, :, :C]                            # [g, E, C]

    # --- dispatch gather ----------------------------------------------------
    xg_pad = torch.cat([xg, torch.zeros((dp, 1, d), dtype=xg.dtype,
                                        device=dev)], dim=1)
    xe = xg_pad[torch.arange(dp, device=dev)[:, None],
                slot_tok.reshape(dp, E * C)].reshape(dp, E, C, d)

    # --- expert FFN ---------------------------------------------------------
    h = F.silu(torch.einsum("gecd,edf->gecf", xe, ctx.cast(p["we_gate"]))) \
        * torch.einsum("gecd,edf->gecf", xe, ctx.cast(p["we_up"]))
    ye = torch.einsum("gecf,efd->gecd", h, ctx.cast(p["we_down"]))

    # --- combine gather -----------------------------------------------------
    flat_slot = e_safe * C + torch.clamp(pos_safe, max=C - 1)   # [g, TK]
    yflat = ye.reshape(dp, E * C, d)[torch.arange(dp, device=dev)[:, None],
                                     flat_slot]
    yflat = yflat * (keep[..., None] * gates.reshape(dp, T * K)[..., None]
                     ).to(yflat.dtype)
    y = torch.sum(yflat.reshape(dp, T, K, d), dim=2)
    y = y.reshape(b, s, d)

    if m.n_shared_experts:
        y = y + mlp(x, p["shared"], ctx)
    return y, aux
