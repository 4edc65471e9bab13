"""Mixture-of-Experts layer: top-k routing, DP-grouped capacity dispatch
(``repro/models/moe.py``).

  * tokens are reshaped to [dp_groups, T, d] so that each data-parallel
    group dispatches its own tokens;
  * slot assignment is a cumsum over a [g, T*k, E] one-hot; tokens beyond
    expert capacity are dropped (GShard semantics);
  * the expert FFN is one grouped einsum over the expert weight stack.

``moe_ffn_ep`` is the expert-parallel form for a device mesh (the
reference's ``shard_map``, here ``local_map``): every ``model`` rank
dispatches its data shard's tokens to its own experts only, and the
partial outputs are summed over ``model``. Without a mesh it is
``moe_ffn``.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate
from torch.distributed.tensor.experimental import local_map

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

    # under a mesh the routing, dispatch and combine index whole tensors
    # (DTensor's index ops and views on a sharded group dim are not
    # reliable); the expert FFN runs on the reference's layout below
    xg = ctx.constrain(x, None, None, None).reshape(dp, T, d)

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

    # slot -> token map: slot_tok[g, e, c] = token index (or T: dummy),
    # written and read within each group (scatter / gather along dim 1)
    tok_of_entry = torch.arange(T * K, device=dev) // K      # [TK]
    e_safe = torch.where(keep, eflat, 0)
    pos_safe = torch.where(keep, pos, C)                     # C -> dropped row
    slot_tok = torch.full((dp, E * (C + 1)), T, dtype=torch.int64,
                          device=dev)
    slot_tok = slot_tok.scatter(1, e_safe * (C + 1) + pos_safe, torch.where(
        keep, tok_of_entry[None], T))
    slot_tok = slot_tok.reshape(dp, E, C + 1)[:, :, :C]      # [g, E, C]

    # --- dispatch gather ----------------------------------------------------
    xg_pad = torch.cat([xg, torch.zeros((dp, 1, d), dtype=xg.dtype,
                                        device=dev)], dim=1)
    xe = torch.gather(xg_pad, 1, slot_tok.reshape(dp, E * C, 1).expand(
        dp, E * C, d)).reshape(dp, E, C, d)
    xe = ctx.constrain(xe, Ax.DP_GROUP, Ax.EXPERT_ACT, None, None)

    # --- expert FFN ---------------------------------------------------------
    h = F.silu(torch.einsum("gecd,edf->gecf", xe, ctx.cast(p["we_gate"]))) \
        * torch.einsum("gecd,edf->gecf", xe, ctx.cast(p["we_up"]))
    ye = torch.einsum("gecf,efd->gecd", h, ctx.cast(p["we_down"]))
    ye = ctx.constrain(ye, Ax.DP_GROUP, Ax.EXPERT_ACT, None, None)

    # --- combine gather -----------------------------------------------------
    flat_slot = e_safe * C + torch.clamp(pos_safe, max=C - 1)   # [g, TK]
    ye = ctx.constrain(ye, None, None, None, None)
    yflat = torch.gather(ye.reshape(dp, E * C, d), 1, flat_slot[..., None]
                         .expand(dp, T * K, d))
    yflat = yflat * (keep[..., None] * gates.reshape(dp, T * K)[..., None]
                     ).to(yflat.dtype)
    y = torch.sum(yflat.reshape(dp, T, K, d), dim=2)
    # the gradient comes back whole through this view too
    y = ctx.constrain(y.reshape(b, s, d), Ax.BATCH, Ax.SEQ, None)

    if m.n_shared_experts:
        y = y + mlp(x, p["shared"], ctx)
    return y, aux


# ---------------------------------------------------------------------------
# Expert parallelism (the reference's shard_map, as local_map)
# ---------------------------------------------------------------------------

def _ep_block(xb, router, wg, wu, wd, *, arch: ArchConfig, C: int,
              rank: int, n_ranks: int):
    """One rank's part: ``xb`` [b_loc, s, d] (this data shard's tokens,
    whole over ``model``), ``router`` whole, ``w*`` [E / ep, ...] this
    model rank's experts. Every rank routes all its tokens, keeps the
    entries of its own experts, and scatter-adds their outputs back to
    the tokens: the partial ``y`` (summed over ``model`` outside) and the
    rank's balance term over ``n_ranks`` (summed over the mesh outside:
    the mean of the ranks' terms)."""
    m = arch.moe
    E, K = m.n_experts, m.top_k
    e_loc = wg.shape[0]
    tb, sb, d = xb.shape
    dev = xb.device
    xt = xb.reshape(tb * sb, d)
    probs = torch.softmax(xt.float() @ router.float(), dim=-1)
    gates, eidx = torch.topk(probs, K, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    me = torch.mean(probs, dim=0)
    ce = torch.mean(F.one_hot(eidx, E).float().sum(dim=1), dim=0) / K
    aux = E * torch.sum(me * ce) / n_ranks

    # global slot positions (every rank computes them alike)
    eflat = eidx.reshape(-1)                                  # [T*K]
    oh = F.one_hot(eflat, E)
    pos = torch.gather(torch.cumsum(oh, 0) - 1, 1, eflat[:, None])[:, 0]
    keep = pos < C

    # this rank's experts only
    lo = rank * e_loc
    own = (eflat >= lo) & (eflat < lo + e_loc) & keep
    e_rel = torch.where(own, eflat - lo, 0)
    pos_s = torch.where(own, pos, C)                          # C: dropped
    tok = torch.arange(eflat.shape[0], device=dev) // K
    slot_tok = torch.full((e_loc, C + 1), tb * sb, dtype=torch.int64,
                          device=dev)
    slot_tok[e_rel, pos_s] = torch.where(own, tok, tb * sb)
    slot_tok = slot_tok[:, :C]

    xt_pad = torch.cat([xt, torch.zeros((1, d), dtype=xt.dtype,
                                        device=dev)], dim=0)
    xe = xt_pad[slot_tok.reshape(-1)].reshape(e_loc, C, d)
    h = F.silu(torch.einsum("ecd,edf->ecf", xe, wg.to(xe.dtype))) \
        * torch.einsum("ecd,edf->ecf", xe, wu.to(xe.dtype))
    ye = torch.einsum("ecf,efd->ecd", h, wd.to(xe.dtype))

    # local combine: each slot's output, gated, back to its token
    gate_slot = torch.zeros((e_loc, C + 1), dtype=torch.float32, device=dev)
    gate_slot = gate_slot.index_put((e_rel, pos_s),
                                    torch.where(own, gates.reshape(-1), 0.0))
    contrib = ye * gate_slot[:, :C, None].to(ye.dtype)
    y = torch.zeros((tb * sb + 1, d), dtype=ye.dtype, device=dev)
    y = y.index_add(0, slot_tok.reshape(-1), contrib.reshape(-1, d))[:-1]
    return y.reshape(tb, sb, d), aux


def moe_ffn_ep(x, p, arch: ArchConfig, ctx: ShardingCtx, *, positions=None):
    """Expert-parallel MoE with explicit per-rank dispatch
    (``repro/models/moe.py::moe_ffn_ep``).

    Under a device mesh it runs ``_ep_block`` through ``local_map``:

      * activations enter sharded over the data axes, replicated over
        ``model`` (a sequence split over ``model`` is gathered at the
        edge);
      * the expert weights enter ``Shard(0)`` over ``model`` (each rank
        its ``E / ep`` experts), the router replicated;
      * every rank routes all its tokens, dispatches only to its own
        experts and scatter-combines locally;
      * ``y`` leaves ``Partial()`` over ``model`` (the reference's
        ``psum``), reduce-scattered onto the sequence's split where the
        sequence is split, ``aux`` the mean of the per-rank balance terms
        over every mesh dim (its ``pmean``);
      * each rank's gradients are its part of the sum: ``Partial()``
        over the mesh dims an input is replicated on (its own experts'
        share over ``model``, its tokens' share over the data axes).

    The capacity is the data shard's, ``_capacity((b // dp) * s, ...)``,
    as in ``moe_ffn``'s DP groups: the two agree up to summation order.
    Without a device mesh it is ``moe_ffn``."""
    if not ctx.places:
        return moe_ffn(x, p, arch, ctx, positions=positions)
    m = arch.moe
    E, K = m.n_experts, m.top_k
    ep = ctx.model_size
    assert E % ep == 0, (E, ep)
    b, s, d = x.shape
    dp = ctx.dp_size
    assert b % dp == 0, (b, dp)
    C = _capacity((b // dp) * s, K, E, m.capacity_factor)
    # a partial sum over a mesh dim of one rank is the whole value
    split = [ctx.mesh.size(i) > 1 for i in range(ctx.mesh.ndim)]
    xpl = ctx.placements((tuple(ctx.mesh_cfg.data_axes), None, None))
    wpl = ctx.placements(("model", None, None))
    rpl = (Replicate(),) * len(split)
    apl = tuple(Partial() if s else Replicate() for s in split)
    ypl = tuple(x if n != "model" else a for n, x, a in
                zip(ctx._names(), xpl, apl))
    wgpl = tuple(w if n == "model" else a for n, w, a in
                 zip(ctx._names(), wpl, apl))
    rank = ctx.mesh.get_local_rank("model")
    fn = local_map(
        functools.partial(_ep_block, arch=arch, C=C, rank=rank,
                          n_ranks=ctx.mesh.size()),
        out_placements=(ypl, apl),
        in_placements=(xpl, rpl, wpl, wpl, wpl),
        in_grad_placements=(ypl, apl, wgpl, wgpl, wgpl),
        device_mesh=ctx.mesh, redistribute_inputs=True)
    y, aux = fn(ctx.place(x, xpl), p["router"], ctx.cast(p["we_gate"]),
                ctx.cast(p["we_up"]), ctx.cast(p["we_down"]))
    aux = aux.redistribute(ctx.mesh, rpl)
    if ctx.seq_split(x.shape):
        y = ctx.constrain(y, Ax.BATCH, Ax.SEQ, None)
    if m.n_shared_experts:
        y = y + mlp(x, p["shared"], ctx)
    return y, aux
