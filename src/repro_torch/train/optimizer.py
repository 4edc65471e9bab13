"""AdamW and SGD with momentum on the reference's parameter tree
(``repro/train/optimizer.py``).

The reference's formula, not ``torch.optim.AdamW``'s, whose arithmetic
differs (it decays the parameters first and adds ``eps`` to
``sqrt(v) / sqrt(c2)``):

  * the warm-up reads the step *before* the increment, the bias
    corrections read it after;
  * the gradients are clipped by ``min(1, clip / max(|g|, 1e-9))`` with
    the global norm over all leaves in fp32;
  * weight decay sits inside the step direction:
    ``p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``.

The moments are declared with the parameters' shapes and axes, and
``step`` is an int32 0-d tensor. The updates run in place under
``torch.no_grad()`` (the counterpart of the reference's donated buffers)
and return the same trees; metrics stay on the device. On a device mesh
the leaves are DTensors (``step`` replicated): the ``_foreach`` updates
run on each leaf's local shard beside its gradient's and moments' (all
on the leaf's placements), and the global norm is over the full leaves.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor

from repro_torch.parallel.sharding import (ParamDecl, full, tree_leaves,
                                           tree_map)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 100


def _is_decl(x):
    return isinstance(x, ParamDecl)


def _is_tensor(x):
    return isinstance(x, torch.Tensor)


def adamw_init_decls(param_decls) -> dict:
    """Moment declarations mirroring the param tree (zeros, same axes)."""
    def zero(d):
        return ParamDecl(d.shape, d.axes, init="zeros", dtype=d.dtype)
    return dict(
        m=tree_map(zero, param_decls, _is_decl),
        v=tree_map(zero, param_decls, _is_decl),
        step=ParamDecl((), (), init="zeros", dtype=torch.int32),
    )


def _schedule(cfg: AdamWConfig, step):
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def global_norm(tree):
    """The fp32 l2 norm over every leaf of ``tree`` (each DTensor leaf's
    norm over the whole leaf: a replicated plain 0-d tensor)."""
    leaves = [g.float() for g in tree_leaves(tree, _is_tensor)]
    norms = [full(n) for n in torch._foreach_norm(leaves)]
    return torch.linalg.vector_norm(torch.stack(norms))


@torch.no_grad()
def adamw_update(params, grads, opt_state, cfg: AdamWConfig):
    """One AdamW step, in place: ``params`` and ``opt_state`` (``m``,
    ``v``, ``step``) are updated and returned with the metrics
    ``grad_norm`` and ``lr`` (0-d tensors)."""
    step = opt_state["step"]
    lr = _schedule(cfg, full(step))
    gn = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-9), max=1.0)
    step.add_(1)
    t = full(step).float()
    c1 = 1.0 - cfg.b1 ** t
    c2 = 1.0 - cfg.b2 ** t

    ps, gs, ms, vs = _shards(params, grads, opt_state["m"], opt_state["v"])
    g = torch._foreach_mul([x.float() for x in gs], scale)
    torch._foreach_mul_(ms, cfg.b1)                      # b1 m + (1 - b1) g
    torch._foreach_add_(ms, g, alpha=1 - cfg.b1)
    torch._foreach_mul_(vs, cfg.b2)                      # b2 v + (1 - b2) g g
    torch._foreach_addcmul_(vs, g, g, value=1 - cfg.b2)
    den = torch._foreach_div(vs, c2)                     # sqrt(v / c2) + eps
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, cfg.eps)
    d = torch._foreach_div(ms, c1)                       # m / c1 / den + wd p
    torch._foreach_div_(d, den)
    torch._foreach_add_(d, ps, alpha=cfg.weight_decay)
    torch._foreach_mul_(d, lr)
    torch._foreach_sub_(ps, d)
    return params, opt_state, dict(grad_norm=gn, lr=lr)


def _shards(params, *trees):
    """The leaves of ``params`` and of ``trees`` (gradients, moments) as
    lists of tensors the elementwise update runs on: a DTensor leaf and
    its companions as their local shards, each companion on the leaf's
    placements first (a gradient redistributed; a moment, placed by the
    same decl, already is). The update is elementwise, so shard by shard
    is the whole update."""
    out = [tree_leaves(params, _is_tensor)] + [
        tree_leaves(t, _is_tensor) for t in trees]
    for i, p in enumerate(out[0]):
        if not isinstance(p, DTensor):
            continue
        for leaves in out:
            x = leaves[i]
            if tuple(x.placements) != tuple(p.placements):
                x = x.redistribute(p.device_mesh, p.placements)
            leaves[i] = x.to_local()
    return out


@torch.no_grad()
def sgd_update(params, grads, opt_state, lr: float = 1e-2,
               momentum: float = 0.9):
    """SGD with momentum, in place: ``m = momentum m + g``, ``p -= lr m``,
    ``step += 1``."""
    ps, gs, ms = _shards(params, grads, opt_state["m"])
    torch._foreach_mul_(ms, momentum)
    torch._foreach_add_(ms, [g.float() for g in gs])
    torch._foreach_add_(ps, ms, alpha=-lr)
    opt_state["step"].add_(1)
    return params, opt_state, {}
